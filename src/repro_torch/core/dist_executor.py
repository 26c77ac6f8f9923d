"""Distributed executor: one sharded program for the whole plan tree.

`core/executor.py` lowers a PhysicalPlan to a single-device program; this
module lowers the SAME plan IR to a sharded program, so the parser,
algebra, optimizer, plan-shape cache and bucket-calibration layers above
stay unchanged. A process holds its shards along an explicit leading
shard axis (core/distributed.py): every shard on the one device, or its
own rank's shard when each shard is a process (core/ranks.py). Per-shard
work runs under `torch.func.vmap` over that axis — one launch of each
kernel's lane form for all of the process's shards — and the exchanges
(`all_to_all`, `all_gather`) run between the vmapped stages, on the
explicit axis or as collectives across the ranks, never inside a vmap.
The result rows are gathered to every process in flat rank order, so
either placement returns the same arrays.

The lowering is PARTITIONING-AWARE (the cascading map-side-join idea):
`analyze_plan` propagates a `Partitioning` property bottom-up — a
subject-variable Scan of the subject-hash sharded store starts hash-
partitioned on its subject column (the store routes by the SAME FNV-1a
hash `shuffle_by_key` routes by, so "partitioned on ?s" and "shuffled by
(?s,)" are the same placement), each join computes its output
partitioning, and a shuffle is emitted ONLY when an input's partitioning
does not already match the join key. A subject-subject star join chain
therefore runs with ZERO exchanges: every step is a pure map-side join.
Inside the one dispatch:

  * Scan    — the store's flat (local_shards * cap) scan buffer viewed
              as (local_shards, cap): row block k is shard k's partition;
              partitioned on its subject column when the subject is a
              variable;
  * MRJoin / MatrixJoin — per side: already aligned -> local (no
              exchange); small right side -> all_gather it and keep the
              big left side in place (one-sided broadcast join);
              otherwise the paper's Map phase: a hash shuffle over the
              mesh (core/distributed.shuffle_by_key) — then each shard
              runs the local Algorithm-1 join (or the matrix backend,
              which composes with elision unchanged);
  * LeftJoin— same strategy menu (only the RIGHT side may broadcast:
              unmatched-left padding is emitted per shard, so the left
              side must stay uniquely placed); unmatched-left padding is
              globally correct because every left row meets ALL right
              rows of its key;
  * CrossJoin — the right side is all_gathered (replicated) and each
              shard crosses its local left slice against it;
  * Filter / Project / UnionAll — purely row-local; Project keeps the
              partitioning property when the partition columns survive;
  * Distinct — elides its co-locating shuffle when the child is already
              hash-partitioned on any subset of its columns (equal rows
              agree on every column, so they already share a shard);
              otherwise rows shuffle by a hash of ALL columns at a
              calibrated per-shard bucket;
  * Slice   — LIMIT/OFFSET against the GLOBAL valid-row rank.

Before the join chain runs, every emitted shuffle whose input is an
exchange-free subtree (scan/filter/project) is issued into a
`distributed.ShuffleSlots` buffer, as the reference does to overlap its
collectives with the local joins; every rank issues them in the same
order.

Everything dynamic rides back in the same dispatch, per shard: exact join
totals, join-bucket overflow flags, exact shuffle bucket needs and
overflow flags — PER SITE AND PER MESH-AXIS STAGE, so an overflow regrows
only the overflowing stage's bucket. Static shapes are all PER-SHARD.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.core import distributed as dj
from repro_torch.core import matrix_join as mxj
from repro_torch.core import mr_join as mj
from repro_torch.core.distributed import ShardMesh
from repro_torch.core.plan_ir import (
    CrossJoin,
    Distinct,
    Filter,
    LeftJoin,
    MatrixJoin,
    MRJoin,
    PhysicalPlan,
    PlanNode,
    Project,
    Scan,
    Slice,
    UnionAll,
    bucket_capacity,
    child_nodes,
)
from repro_torch.core.relation import Relation
from repro_torch.core.segments import cumsum_i32

# global-row threshold below which a misaligned join input is replicated
# (all_gather) instead of shuffling BOTH sides: one exchange moving few
# rows, and the big side's partitioning survives the join
DEFAULT_BROADCAST_ROWS = 2048


class ShardedChainResult(NamedTuple):
    """Everything one sharded dispatch returns (device-resident).

    `relation` rows are flat in shard order (shard k's slice is row block
    k), every shard's on every process; the per-join and per-shuffle
    accounting keeps the process's own shards on the shard axis, so the
    host can gather them and regrow buckets from the worst shard's exact
    numbers. The shuffle arrays carry one slot per site PER MESH-AXIS
    STAGE (n_sites * n_stages, site-major), so a hierarchical shuffle's
    stages regrow independently. A stacked batch adds a leading lane
    axis to every field.
    """

    relation: Relation  # (n_shards * cap_out, n_cols)
    totals: torch.Tensor  # (local_shards, n_joins) exact local join totals
    overflows: torch.Tensor  # (local_shards, n_joins) join bucket truncated
    shuffle_needs: torch.Tensor  # (local_shards, n_sites * n_stages) load
    shuffle_flags: torch.Tensor  # (local_shards, n_sites * n_stages) dropped


# -- partitioning property (the map-side-join lattice) ------------------------


@dataclasses.dataclass(frozen=True)
class Partitioning:
    """Where a relation's rows live across the mesh.

    hash(cols)  — the row with values v over `cols` lives on shard
                  FNV1a(v) % n_shards (column ORDER matters: the hash is
                  over the tuple in this order — exactly
                  distributed.hash_keys' routing);
    replicated  — every shard holds every row (an all_gather output);
    unknown     — arbitrary placement (the lattice bottom).
    """

    kind: str  # "hash" | "replicated" | "unknown"
    cols: tuple[str, ...] = ()

    def __str__(self) -> str:
        if self.kind == "hash":
            return "hash(" + ",".join(self.cols) + ")"
        return self.kind


UNKNOWN = Partitioning("unknown")
REPLICATED = Partitioning("replicated")


def hash_part(cols) -> Partitioning:
    cols = tuple(cols)
    assert cols
    return Partitioning("hash", cols)


@dataclasses.dataclass(frozen=True)
class SiteStrategy:
    """One shuffle site's chosen data movement.

    op: "mr_join" | "matrix_join" | "left_join" | "cross_join" | "distinct"
    left / right: "local" (elided — input already aligned), "shuffle"
    (emitted exchange), "broadcast" (small side all_gathered),
    "gather" (cross join's structural replication), "-" (no such side:
    distinct uses `left` for its only input).
    """

    op: str
    key: tuple[str, ...]
    left: str = "-"
    right: str = "-"

    @property
    def emitted(self) -> int:
        return int(self.left == "shuffle") + int(self.right == "shuffle")

    @property
    def elided(self) -> int:
        return int(self.left == "local") + int(self.right == "local")

    @property
    def broadcast(self) -> bool:
        return self.right == "broadcast"


def strategy_counts(strategies) -> dict[str, int]:
    """Aggregate emitted/elided/broadcast counts for stats and explain()."""
    return {
        "emitted": sum(s.emitted for s in strategies),
        "elided": sum(s.elided for s in strategies),
        "broadcast": sum(1 for s in strategies if s.broadcast),
    }


def format_strategy(st: SiteStrategy) -> str:
    """One shuffle site's data-movement decision as the explain() line."""
    if st.op == "cross_join":
        return "right side replicated (all_gather)"
    if st.op == "distinct":
        return (
            "shuffle by all columns (emitted)"
            if st.left == "shuffle"
            else "co-located already (shuffle elided)"
        )
    sides = []
    for name, action in (("left", st.left), ("right", st.right)):
        if action == "local":
            sides.append(f"{name} map-side (shuffle elided)")
        elif action == "shuffle":
            sides.append(f"{name} shuffle emitted")
        elif action == "broadcast":
            sides.append(f"{name} broadcast (all_gather)")
    return ", ".join(sides) + f" on key ({', '.join(st.key)})"


def analyze_plan(
    plan: PhysicalPlan,
    n_shards: int,
    broadcast_rows: int = DEFAULT_BROADCAST_ROWS,
) -> tuple[SiteStrategy, ...]:
    """Propagate Partitioning bottom-up and fix each site's strategy.

    Pure host-side static analysis (capacities and schemas only), so the
    engine can show the chosen/elided shuffles in explain() and count
    them in ExecStats without touching the device. Strategies are in
    shuffle-site order (`shuffle_site_nodes`). Rules:

      Scan      -> hash(subject col) when the subject is a variable
      Filter    -> child's (masks move no rows)
      Project   -> child's if every partition column survives, else unknown
      UnionAll  -> the common child partitioning, if all agree
      Join      -> per side "local" iff its partitioning == hash(key)
                   (trivially true at n_shards == 1); a misaligned small
                   right side broadcasts instead of shuffling both sides;
                   output is hash(key), or the left partitioning under a
                   broadcast (left rows never move)
      Distinct  -> "local" iff the child is hash-partitioned on a subset
                   of its columns (equal rows agree on every column, so
                   they co-locate already); else shuffle by all columns
      Slice     -> child's (global-rank masking moves no rows)
    """
    strategies: list[SiteStrategy] = []
    parts: dict[int, Partitioning] = {}

    def aligned(p: Partitioning, key: tuple[str, ...]) -> bool:
        return n_shards == 1 or (p.kind == "hash" and p.cols == key)

    def restrict(p: Partitioning, schema) -> Partitioning:
        if p.kind == "hash" and not all(c in schema for c in p.cols):
            return UNKNOWN  # a partition column was projected away
        return p

    def part(node: PlanNode) -> Partitioning:
        hit = parts.get(id(node))
        if hit is not None:
            return hit
        p = _part(node)
        parts[id(node)] = p
        return p

    def _part(node: PlanNode) -> Partitioning:
        if isinstance(node, Scan):
            if node.part_col >= 0:
                return hash_part((node.schema[node.part_col],))
            return UNKNOWN
        if isinstance(node, (MRJoin, MatrixJoin, LeftJoin)):
            pl = part(node.left)
            pr = part(node.right)
            key = tuple(node.key_vars)
            op = (
                "left_join" if isinstance(node, LeftJoin)
                else "matrix_join" if isinstance(node, MatrixJoin)
                else "mr_join"
            )
            left = "local" if aligned(pl, key) else "shuffle"
            right = "local" if aligned(pr, key) else "shuffle"
            if (
                left == "shuffle"
                and right == "shuffle"
                and node.right.capacity * n_shards <= broadcast_rows
            ):
                # replicate the small right side and keep every left row
                # in place (sound for LeftJoin too: each left row meets
                # ALL right rows of its key, and exists on exactly one
                # shard, so inner matches and unmatched padding are both
                # globally exact)
                left, right = "local", "broadcast"
                out = restrict(pl, node.schema)
            else:
                out = hash_part(key) if key else UNKNOWN
            strategies.append(SiteStrategy(op, key, left, right))
            return out
        if isinstance(node, CrossJoin):
            pl = part(node.left)
            part(node.right)  # visit: nested sites keep evaluation order
            strategies.append(
                SiteStrategy("cross_join", (), "local", "gather")
            )
            return restrict(pl, node.schema)
        if isinstance(node, Filter):
            return part(node.child)
        if isinstance(node, Project):
            return restrict(part(node.child), node.schema)
        if isinstance(node, UnionAll):
            ps = [part(c) for c in node.children]
            if ps and all(p == ps[0] for p in ps) and ps[0].kind == "hash":
                return restrict(ps[0], node.schema)
            return UNKNOWN
        if isinstance(node, Distinct):
            p = part(node.child)
            schema = tuple(node.schema)
            local = (
                n_shards == 1
                or not schema
                or (p.kind == "hash" and set(p.cols) <= set(schema))
            )
            strategies.append(
                SiteStrategy(
                    "distinct", schema, "local" if local else "shuffle"
                )
            )
            return p if local else hash_part(schema)
        if isinstance(node, Slice):
            return part(node.child)
        raise TypeError(f"unknown plan node {node!r}")

    part(plan.root)
    assert len(strategies) == n_shuffle_sites(plan)
    return tuple(strategies)


# -- shuffle-site enumeration -------------------------------------------------


def shuffle_site_nodes(plan: PhysicalPlan) -> list[PlanNode]:
    """Shuffle sites in evaluation (post-)order: one per join step (MRJoin
    / MatrixJoin / LeftJoin / CrossJoin — the cross join's slot is
    structural) plus one per Distinct. The id-dedup matches the
    evaluator's memoised first-visit order on DAG plans."""
    sites: list[PlanNode] = []
    seen: set[int] = set()

    def walk(node: PlanNode) -> None:
        if id(node) in seen:
            return
        seen.add(id(node))
        for child in child_nodes(node):
            walk(child)
        if isinstance(
            node, (MRJoin, MatrixJoin, LeftJoin, CrossJoin, Distinct)
        ):
            sites.append(node)

    walk(plan.root)
    return sites


def n_shuffle_sites(plan: PhysicalPlan) -> int:
    return len(shuffle_site_nodes(plan))


def n_shuffle_slots(plan: PhysicalPlan, n_stages: int) -> int:
    """Shuffle cap slots: one per site per mesh-axis stage (site-major)."""
    return n_shuffle_sites(plan) * n_stages


def initial_shuffle_caps(
    plan: PhysicalPlan,
    axis_sizes: "tuple[int, ...] | int",
    floor: int = 8,
) -> tuple[int, ...]:
    """Starting shuffle bucket per (site, stage): the uniform-distribution
    estimate — stage k routes rows to axis_sizes[k] destinations, so its
    per-destination load is ~worst-input / axis_sizes[k]. Skewed keys
    overflow the first dispatch, which reports the exact per-stage need —
    one regrow converges, exactly like the join buckets."""
    if isinstance(axis_sizes, int):
        axis_sizes = (axis_sizes,)
    caps: list[int] = []
    for node in shuffle_site_nodes(plan):
        if isinstance(node, Distinct):
            worst = node.capacity
        else:
            worst = max(node.left.capacity, node.right.capacity)
        for size in axis_sizes:
            caps.append(bucket_capacity(max(floor, -(-worst // size))))
    return tuple(caps)


def _collective_free(node: PlanNode, memo: dict[int, bool]) -> bool:
    """True when evaluating `node` runs no exchange (so its shuffle can
    be issued ahead of the whole join chain)."""
    hit = memo.get(id(node))
    if hit is not None:
        return hit
    if isinstance(
        node, (MRJoin, MatrixJoin, LeftJoin, CrossJoin, Distinct, Slice)
    ):
        free = False
    else:
        free = all(_collective_free(c, memo) for c in child_nodes(node))
    memo[id(node)] = free
    return free


# -- the lowering -------------------------------------------------------------


def _local(fn: Callable, *args):
    """Per-shard work: `fn` over one shard's arguments, vmapped over the
    leading shard axis of every argument."""
    return torch.func.vmap(fn)(*args)


def _local_program(
    plan: PhysicalPlan,
    mesh: ShardMesh,
    shuffle_caps: tuple[int, ...],
    strategies: tuple[SiteStrategy, ...],
) -> Callable[..., ShardedChainResult]:
    """The sharded program over explicit shard axes: plan tree -> function
    of (scans, consts_i, consts_f, num_vals) whose scans and constants
    carry a leading (lanes * local_shards) axis and whose every output
    field does too; `num_vals` is shared by every shard."""
    n_stages = len(mesh.axis_names)
    site_nodes = shuffle_site_nodes(plan)
    site_of = {id(n): i for i, n in enumerate(site_nodes)}
    assert len(shuffle_caps) == len(site_nodes) * n_stages, (
        shuffle_caps, len(site_nodes), n_stages,
    )

    def site_caps(i: int) -> tuple[int, ...]:
        return tuple(shuffle_caps[i * n_stages:(i + 1) * n_stages])

    def run(
        scans: tuple[Relation, ...],
        consts_i: torch.Tensor,
        consts_f: torch.Tensor,
        num_vals: torch.Tensor,
    ) -> ShardedChainResult:
        b = consts_i.shape[0]
        dev = consts_i.device
        totals: list[torch.Tensor] = []
        flags: list[torch.Tensor] = []
        sh_needs: list = [None] * len(site_nodes)
        sh_flags: list = [None] * len(site_nodes)
        memo: dict[int, Relation] = {}
        slots = dj.ShuffleSlots()

        def zero_acct():
            return (
                torch.zeros((b, n_stages), dtype=torch.int32, device=dev),
                torch.zeros((b, n_stages), dtype=torch.bool, device=dev),
            )

        def shuffled(node: PlanNode, side: str, rel: Relation):
            """Shuffle one join input by the node's key — consuming the
            prestaged slot when the prestage pass issued it."""
            slot = (id(node), side)
            if slots.ready(slot):
                cols, valid, ov, need = slots.take(slot)
            else:
                idx = [rel.schema.index(v) for v in node.key_vars]
                cols, valid, ov, need = dj.shuffle_by_key(
                    rel.cols, rel.valid, idx, mesh,
                    site_caps(site_of[id(node)]),
                )
            return Relation(rel.schema, cols, valid), ov, need

        def replicate(rel: Relation) -> Relation:
            return Relation(
                rel.schema,
                dj.all_gather(rel.cols, mesh),
                dj.all_gather(rel.valid, mesh),
            )

        def eval_node(node: PlanNode) -> Relation:
            hit = memo.get(id(node))
            if hit is not None:
                return hit
            rel = _eval(node)
            memo[id(node)] = rel
            return rel

        def _eval(node: PlanNode) -> Relation:
            if isinstance(node, Scan):
                return scans[node.index]
            if isinstance(node, (MRJoin, MatrixJoin, LeftJoin)):
                si = site_of[id(node)]
                st = strategies[si]
                left = eval_node(node.left)
                right = eval_node(node.right)
                need, ov_sh = zero_acct()
                if st.left == "shuffle":
                    left, ov, nd = shuffled(node, "left", left)
                    need, ov_sh = torch.maximum(need, nd), ov_sh | ov
                if st.right == "shuffle":
                    right, ov, nd = shuffled(node, "right", right)
                    need, ov_sh = torch.maximum(need, nd), ov_sh | ov
                elif st.right == "broadcast":
                    right = replicate(right)
                if isinstance(node, LeftJoin):
                    ljoin = (
                        mxj.matrix_left_join if node.backend == "matrix"
                        else mj.left_join
                    )
                    out, total, ovf = _local(
                        lambda l, r: ljoin(l, r, capacity=node.join_cap),
                        left, right,
                    )
                else:
                    join = (
                        mxj.matrix_join if isinstance(node, MatrixJoin)
                        else mj.mr_join
                    )
                    out, total, ovf = _local(
                        lambda l, r: join(l, r, capacity=node.capacity),
                        left, right,
                    )
                totals.append(total)
                flags.append(ovf)
                sh_needs[si], sh_flags[si] = need, ov_sh
                return out
            if isinstance(node, CrossJoin):
                si = site_of[id(node)]
                left = eval_node(node.left)
                r_all = replicate(eval_node(node.right))
                # every (local-left, global-right) position is enumerated:
                # exact, like the single-device cross join
                cap = left.capacity * r_all.capacity
                out, total, ovf = _local(
                    lambda l, r: mj.cross_join(l, r, capacity=cap),
                    left, r_all,
                )
                totals.append(total)
                flags.append(ovf)
                sh_needs[si], sh_flags[si] = zero_acct()
                return _local(mj.compact, out)
            if isinstance(node, Filter):
                child = eval_node(node.child)
                keep = _local(
                    lambda c, ci, cf: mj.filter_mask(
                        c, node.conds, ci, cf, num_vals
                    ),
                    child, consts_i, consts_f,
                )
                return Relation(child.schema, child.cols, keep)
            if isinstance(node, UnionAll):
                kids = [eval_node(c) for c in node.children]
                return _local(
                    lambda *ks: mj.union_all(list(ks), node.schema), *kids
                )
            if isinstance(node, Project):
                return _local(
                    lambda c: c.project(list(node.schema)),
                    eval_node(node.child),
                )
            if isinstance(node, Distinct):
                si = site_of[id(node)]
                st = strategies[si]
                child = eval_node(node.child)
                if st.left == "shuffle":
                    # co-locate equal rows at a calibrated per-shard
                    # bucket; elided when the child is already hash-
                    # partitioned on a subset of its columns
                    cols, valid, ov, need = dj.shuffle_by_key(
                        child.cols, child.valid, list(range(child.n_cols)),
                        mesh, site_caps(si),
                    )
                    child = Relation(child.schema, cols, valid)
                    sh_needs[si], sh_flags[si] = need, ov
                else:
                    sh_needs[si], sh_flags[si] = zero_acct()
                return _local(mj.distinct, child)
            if isinstance(node, Slice):
                # the global valid-row rank: rows of lower-ranked shards
                # (flat rank order) come first, so each shard needs every
                # shard's count of its lane
                child = eval_node(node.child)
                count = child.valid.sum(dim=1, dtype=torch.int32)
                per_lane = dj.gather_shards(count[:, None], mesh)
                prev = dj.own_shards(cumsum_i32(per_lane) - per_lane, mesh)
                offset = consts_i[:, node.offset_index, None]
                limit = consts_i[:, node.limit_index, None]
                rank = prev[:, None] + cumsum_i32(child.valid)
                keep = (
                    child.valid
                    & (rank > offset)
                    & (rank <= offset + limit)
                )
                return Relation(child.schema, child.cols, keep)
            raise TypeError(f"unknown plan node {node!r}")

        # prestage: issue every emitted shuffle whose input is an
        # exchange-free subtree BEFORE the join chain runs
        free_memo: dict[int, bool] = {}
        for node in site_nodes:
            if not isinstance(node, (MRJoin, MatrixJoin, LeftJoin)):
                continue
            st = strategies[site_of[id(node)]]
            for side, child, action in (
                ("left", node.left, st.left),
                ("right", node.right, st.right),
            ):
                if action == "shuffle" and _collective_free(
                    child, free_memo
                ):
                    rel = eval_node(child)
                    idx = [rel.schema.index(v) for v in node.key_vars]
                    slots.issue(
                        (id(node), side), rel.cols, rel.valid, idx,
                        mesh, site_caps(site_of[id(node)]),
                    )

        rel = eval_node(plan.root)
        assert len(totals) == len(plan.join_caps), (
            len(totals), plan.join_caps,
        )
        assert all(x is not None for x in sh_needs), sh_needs

        def stacked(xs: list, dtype, cat) -> torch.Tensor:
            if not xs:
                return torch.zeros((b, 0), dtype=dtype, device=dev)
            return torch.cat(xs, 1) if cat else torch.stack(xs, 1)

        return ShardedChainResult(
            rel,
            stacked(totals, torch.int32, False),
            stacked(flags, torch.bool, False),
            stacked(sh_needs, torch.int32, True),
            stacked(sh_flags, torch.bool, True),
        )

    return run


def _split_rows(x: torch.Tensor, n_shards: int, stacked: bool) -> torch.Tensor:
    """Flat row blocks -> one block per shard: (n_shards * cap, ...) ->
    (n_shards, cap, ...), or with a leading lane axis (`stacked`)
    (width, n_shards * cap, ...) -> (width * n_shards, cap, ...)."""
    rows = int(stacked)
    return x.reshape(-1, x.shape[rows] // n_shards, *x.shape[rows + 1:])


def lower_sharded(
    plan: PhysicalPlan,
    mesh: ShardMesh,
    shuffle_caps: tuple[int, ...],
    broadcast_rows: int = DEFAULT_BROADCAST_ROWS,
) -> Callable[..., ShardedChainResult]:
    """Plan tree -> function of (scans, consts_i, consts_f, num_vals) with
    the single-device program's call signature: scans are the store's
    flat (local_shards * cap, n_cols) buffers (every shard's block, or
    across ranks the rank's own), constants are shared by every shard,
    and the result's rows come back flat in shard order, every shard's
    on every process. The accounting keeps the process's own shards.

    Join/shuffle accounting is collected in evaluation order — the same
    order `build_plan` consumes join_caps in. `shuffle_caps` carries
    n_shuffle_slots(plan, len(mesh.axis_names)) entries: per shuffle site
    (join steps in join_caps order — cross joins keep a structural slot —
    plus one per Distinct), one bucket per mesh-axis stage."""
    s = mesh.local_shards
    local_run = _local_program(
        plan, mesh, shuffle_caps,
        analyze_plan(plan, mesh.n_shards, broadcast_rows),
    )

    def run(scans, consts_i, consts_f, num_vals) -> ShardedChainResult:
        split = tuple(
            Relation(
                r.schema,
                _split_rows(r.cols, s, False),
                _split_rows(r.valid, s, False),
            )
            for r in scans
        )
        res = local_run(
            split, consts_i.expand(s, -1), consts_f.expand(s, -1), num_vals
        )
        out = dj.gather_relation(res.relation, mesh)
        return res._replace(relation=Relation(
            out.schema, out.cols.reshape(-1, out.n_cols),
            out.valid.reshape(-1),
        ))

    return run


@dataclasses.dataclass
class CompiledShardedPlan:
    """The sharded program for one (shape, per-shard join caps, per-shard
    per-stage shuffle caps) point. Call-compatible with
    executor.CompiledPlan so the engine's cache entries can hold either.
    `strategies` records each site's chosen data movement (emitted /
    elided / broadcast) for stats and explain()."""

    plan: PhysicalPlan
    shuffle_caps: tuple[int, ...]
    n_shards: int
    program: Callable[..., ShardedChainResult]
    strategies: tuple[SiteStrategy, ...] = ()

    def __call__(
        self,
        scans: tuple[Relation, ...],
        consts_i: torch.Tensor,
        consts_f: torch.Tensor,
        num_vals: torch.Tensor,
    ) -> ShardedChainResult:
        return self.program(scans, consts_i, consts_f, num_vals)


def compile_sharded_plan(
    plan: PhysicalPlan,
    mesh: ShardMesh,
    shuffle_caps: tuple[int, ...],
    broadcast_rows: int = DEFAULT_BROADCAST_ROWS,
) -> CompiledShardedPlan:
    """Build the sharded program (the engine's only entry point for one,
    so its n_compiles accounting stays exact — warm queries report
    zero)."""
    return CompiledShardedPlan(
        plan, tuple(shuffle_caps), mesh.n_shards,
        lower_sharded(plan, mesh, shuffle_caps, broadcast_rows),
        analyze_plan(plan, mesh.n_shards, broadcast_rows),
    )


# -- batched (lanes x shards) execution ---------------------------------------


def lower_sharded_batched(
    plan: PhysicalPlan,
    mesh: ShardMesh,
    shuffle_caps: tuple[int, ...],
    scan_axes: tuple,
    broadcast_rows: int = DEFAULT_BROADCAST_ROWS,
) -> Callable[..., ShardedChainResult]:
    """Stacked variant of `lower_sharded`: ONE dispatch executes a whole
    lane batch of warm same-shape queries (lanes x shards), the
    distributed mirror of executor.lower_batched.

    The lane and shard axes are flattened into one (lane-major) for the
    per-shard stages, so each kernel call is still one launch for every
    (lane, shard); the exchanges reshape that axis back into (lanes,
    shards) and move rows only between shards of one lane. `scan_axes` is
    the per-scan lane axis: 0 for a (width, local_shards * cap, n_cols)
    stacked buffer, None for a (local_shards * cap, n_cols) scan every
    lane shares; the result's rows come back (width, n_shards * cap_out)
    on every process, the accounting (width, local_shards, slots). A
    `(width,)` bool `lane_active` mask zeroes padding lanes' scan
    validity and overflow flags, so padding can never emit rows or
    trigger a regrow."""
    s = mesh.local_shards
    local_run = _local_program(
        plan, mesh, shuffle_caps,
        analyze_plan(plan, mesh.n_shards, broadcast_rows),
    )
    axes = tuple(scan_axes)

    def run(scans, consts_i, consts_f, num_vals, lane_active):
        width = lane_active.shape[0]

        def per_shard(x: torch.Tensor) -> torch.Tensor:
            # (width, n) -> (width * local_shards, n), lane-major
            return x[:, None].expand(width, s, *x.shape[1:]).reshape(
                width * s, *x.shape[1:]
            )

        active = per_shard(lane_active[:, None])  # (width * local_shards, 1)
        split = []
        for r, ax in zip(scans, axes):
            cols, valid = r.cols, r.valid
            if ax is None:
                cols = cols.expand(width, *cols.shape)
                valid = valid.expand(width, *valid.shape)
            split.append(Relation(
                r.schema,
                _split_rows(cols, s, True),
                _split_rows(valid, s, True) & active,
            ))
        res = local_run(
            tuple(split), per_shard(consts_i), per_shard(consts_f), num_vals
        )
        out = dj.gather_relation(res.relation, mesh)

        def lanes(x: torch.Tensor) -> torch.Tensor:
            return x.reshape(width, s, *x.shape[1:])

        return ShardedChainResult(
            out,
            lanes(res.totals),
            lanes(res.overflows & active),
            lanes(res.shuffle_needs),
            lanes(res.shuffle_flags & active),
        )

    return run


@dataclasses.dataclass
class CompiledShardedBatch:
    """A width-W lanes-x-shards program for one (shape, join caps, shuffle
    caps) point — any group of <= W warm same-shape queries whose scans
    stack the same way dispatches through it."""

    plan: PhysicalPlan
    width: int
    shuffle_caps: tuple[int, ...]
    n_shards: int
    program: Callable[..., ShardedChainResult]
    scan_axes: tuple = ()
    strategies: tuple[SiteStrategy, ...] = ()

    def __call__(
        self,
        scans: tuple[Relation, ...],
        consts_i: torch.Tensor,
        consts_f: torch.Tensor,
        num_vals: torch.Tensor,
        lane_active: torch.Tensor,
    ) -> ShardedChainResult:
        return self.program(scans, consts_i, consts_f, num_vals, lane_active)


def compile_sharded_plan_batched(
    plan: PhysicalPlan,
    mesh: ShardMesh,
    shuffle_caps: tuple[int, ...],
    width: int,
    scan_axes: tuple,
    broadcast_rows: int = DEFAULT_BROADCAST_ROWS,
) -> CompiledShardedBatch:
    """Build the stacked sharded program at batch width `width` (scans at
    a None axis in `scan_axes` arrive UNstacked)."""
    return CompiledShardedBatch(
        plan,
        int(width),
        tuple(shuffle_caps),
        mesh.n_shards,
        lower_sharded_batched(
            plan, mesh, shuffle_caps, tuple(scan_axes), broadcast_rows
        ),
        tuple(scan_axes),
        analyze_plan(plan, mesh.n_shards, broadcast_rows),
    )
