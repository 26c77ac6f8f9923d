"""Physical-plan IR for the MapSQ join chain.

The optimizer (sparql/optimizer.py) decides the join ORDER and the filter
attachment stages; this module turns them into a *physical* plan — a tree
(a DAG when UNION branches share the required chain) of frozen, hashable
nodes (Scan / MRJoin / CrossJoin / LeftJoin / Filter / UnionAll / Project /
Distinct / Slice) whose static capacities are the shapes a compiled
executor is specialised on (core/executor.py lowers the tree to one
device program).

Three properties make plans reusable across queries, which is the whole
point of the plan/compile cache in sparql/engine.py:

  * capacity bucketing — every capacity is quantised to a pow-2 bucket with
    a floor (`bucket_capacity`), so near-miss result sizes land on the same
    static shape instead of forcing a recompile per query;
  * variable canonicalisation — variable names are renamed ?c0, ?c1, ... in
    plan order (`canonical_renaming`), so two queries that differ only in
    variable spelling (or in the constants inside their patterns — those
    live in the scan *data*, not the plan) share one compiled program;
  * runtime constants — FILTER comparison constants and LIMIT/OFFSET values
    are NOT part of the plan: they are passed to the compiled program as
    int/float input arrays (FilterExpr comparison leaves store an *index*
    into them), so queries differing only in a filter constant or a limit
    share one executable too.

`PlanShape` is the hashable cache key: scan schemas + scan buckets + join
structure (required chain plus OPTIONAL group specs) + filter structure +
projection + distinct + slice presence. `build_plan(shape, join_caps)`
fills in the per-join bucket capacities (learned from the calibration run
or grown by the overflow-retry fallback) and yields the node tree.
"""
from __future__ import annotations

import dataclasses
from typing import Union

# Pow-2 bucket floor: tiny relations all share the same smallest shape.
MIN_BUCKET = 8

# FILTER expressions are nested hashable tuples:
#   ("cmp", lhs_var, op, kind, ref) — a comparison, where kind is
#       "var" — ref is the rhs variable name;
#       "id"  — ref indexes the int runtime-constants array (term identity);
#       "num" — ref indexes the float runtime-constants array (numeric);
#   ("and", (expr, ...)) / ("or", (expr, ...)) — boolean combination.
FilterExpr = tuple

# Where the optimizer attached a filter conjunct in the operator tree:
#   ("scan", i)  — masks scan i before it joins anything;
#   ("req", j)   — after required-chain join j (0-based);
#   ("opt", g)   — after OPTIONAL group g's left join;
#   ("bjoin", b) — after UNION branch b was joined with the required chain
#                  (or after the branch's own chain when none exists);
#   ("top",)     — after the whole tree, before projection (the unoptimized
#                  position — always sound).
FilterStage = tuple
FilterSpec = tuple[FilterStage, FilterExpr]


def expr_vars(expr: FilterExpr) -> tuple[str, ...]:
    """Variables a plan-level filter expression reads, in first appearance
    order."""
    if expr[0] == "cmp":
        _, lhs, _op, kind, ref = expr
        return (lhs, ref) if kind == "var" else (lhs,)
    out: list[str] = []
    for child in expr[1]:
        for v in expr_vars(child):
            if v not in out:
                out.append(v)
    return tuple(out)


def rename_expr(expr: FilterExpr, rn: dict[str, str]) -> FilterExpr:
    """Apply a variable renaming to a filter expression."""
    if expr[0] == "cmp":
        _, lhs, op, kind, ref = expr
        return (
            "cmp",
            rn.get(lhs, lhs),
            op,
            kind,
            rn.get(ref, ref) if kind == "var" else ref,
        )
    return (expr[0], tuple(rename_expr(c, rn) for c in expr[1]))


def format_expr(expr: FilterExpr) -> str:
    if expr[0] == "cmp":
        _, lhs, op, kind, ref = expr
        rhs = ref if kind == "var" else f"{kind}[{ref}]"
        return f"{lhs} {op} {rhs}"
    sep = " && " if expr[0] == "and" else " || "
    return "(" + sep.join(format_expr(c) for c in expr[1]) + ")"


def next_pow2(n: int) -> int:
    return 1 << max(0, (max(1, n) - 1).bit_length())


def bucket_capacity(n: int, floor: int = MIN_BUCKET) -> int:
    """Quantise a row count to its static capacity bucket (pow-2, floored)."""
    return max(floor, next_pow2(int(n)))


def floor_pow2(n: int) -> int:
    return 1 << (max(1, int(n)).bit_length() - 1)


def bucket_width(n: int, max_width: int) -> int:
    """Pow-2 batch-width bucket for a stacked same-shape dispatch.

    Groups of nearby sizes land on the same width, so a warm (shape, caps,
    width) executable is reused across micro-batches instead of
    recompiling per exact group size; the lanes past the real group are
    padding, masked out by the executor's per-lane validity mask
    (executor.lower_batched) so they never contribute rows or overflow
    flags. `max_width` is a lane CAP (it bounds device memory per
    dispatch), so a non-pow-2 value clamps DOWN to its floor bucket —
    callers must chunk groups at `floor_pow2(max_width)` lanes.
    """
    return min(next_pow2(int(n)), floor_pow2(max_width))


# -- plan nodes --------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Scan:
    """A partial-match relation, fed in as executor input `scans[index]`.

    `part_col` is the schema position the rows are hash-partitioned on
    across a sharded store's mesh (-1 = none). A subject-variable scan of
    the subject-hash sharded store is partitioned on its subject column:
    shard k holds exactly the rows whose subject FNV-hashes to k — the
    same hash and routing core/distributed.shuffle_by_key uses — which is
    what lets the distributed lowering elide the shuffle of an already-
    aligned join input (core/dist_executor.analyze_plan). Single-device
    plans leave it at -1; it does not exist at runtime, only as lowering
    metadata."""

    index: int
    schema: tuple[str, ...]
    capacity: int
    part_col: int = -1


@dataclasses.dataclass(frozen=True)
class MRJoin:
    """Algorithm-1 MapReduce join at a static output capacity."""

    left: "PlanNode"
    right: "PlanNode"
    key_vars: tuple[str, ...]
    schema: tuple[str, ...]
    capacity: int


@dataclasses.dataclass(frozen=True)
class MatrixJoin:
    """The same equi-join lowered through the masked-SpMM backend
    (core/matrix_join.py): no sort, dense tiled key compares + a scatter
    expansion. Identical contract to MRJoin — same output schema, exact
    total, exact truncation — so the two are freely interchangeable per
    node; the optimizer picks from selectivity x skew."""

    left: "PlanNode"
    right: "PlanNode"
    key_vars: tuple[str, ...]
    schema: tuple[str, ...]
    capacity: int


@dataclasses.dataclass(frozen=True)
class CrossJoin:
    """Cartesian product for disconnected BGP components.

    Capacity is always the full left×right product: cross_join enumerates
    pair POSITIONS, so a smaller capacity could silently drop valid pairs
    (unlike MRJoin, whose overflow flag is exact).
    """

    left: "PlanNode"
    right: "PlanNode"
    schema: tuple[str, ...]
    capacity: int


@dataclasses.dataclass(frozen=True)
class LeftJoin:
    """OPTIONAL: MRJoin plus unmatched-left rows padded with UNBOUND.

    `join_cap` is the calibrated/grown bucket for the inner-join part; the
    node's output capacity is join_cap + left.capacity (the padding slots
    are exact, they can never overflow). `backend` selects the physical
    algebra for the inner join ("mr" or "matrix").
    """

    left: "PlanNode"
    right: "PlanNode"
    key_vars: tuple[str, ...]
    schema: tuple[str, ...]
    join_cap: int
    backend: str = "mr"

    @property
    def capacity(self) -> int:
        return self.join_cap + self.left.capacity


@dataclasses.dataclass(frozen=True)
class Filter:
    """Device-side validity mask from filter expressions (conjunction)."""

    child: "PlanNode"
    conds: tuple[FilterExpr, ...]

    @property
    def schema(self) -> tuple[str, ...]:
        return self.child.schema

    @property
    def capacity(self) -> int:
        return self.child.capacity


@dataclasses.dataclass(frozen=True)
class UnionAll:
    """SPARQL UNION: device-side multiset concatenation of the branches.

    The output schema is the first-appearance union of the child schemas;
    columns a branch does not bind are padded with the UNBOUND sentinel.
    Capacity is the exact sum of the children's capacities — concatenation
    can never overflow, so UNION adds no calibrated bucket of its own.
    """

    children: tuple["PlanNode", ...]
    schema: tuple[str, ...]

    @property
    def capacity(self) -> int:
        return sum(c.capacity for c in self.children)


@dataclasses.dataclass(frozen=True)
class Project:
    child: "PlanNode"
    schema: tuple[str, ...]

    @property
    def capacity(self) -> int:
        return self.child.capacity


@dataclasses.dataclass(frozen=True)
class Distinct:
    child: "PlanNode"

    @property
    def schema(self) -> tuple[str, ...]:
        return self.child.schema

    @property
    def capacity(self) -> int:
        return self.child.capacity


@dataclasses.dataclass(frozen=True)
class Slice:
    """LIMIT/OFFSET: the actual values are runtime inputs (indexes into the
    int constants array), so one program serves every limit."""

    child: "PlanNode"
    offset_index: int
    limit_index: int

    @property
    def schema(self) -> tuple[str, ...]:
        return self.child.schema

    @property
    def capacity(self) -> int:
        return self.child.capacity


PlanNode = Union[
    Scan, MRJoin, MatrixJoin, CrossJoin, LeftJoin, Filter, UnionAll,
    Project, Distinct, Slice,
]


def child_nodes(node: PlanNode) -> list[PlanNode]:
    if isinstance(node, UnionAll):
        return list(node.children)
    return [
        getattr(node, a)
        for a in ("left", "right", "child")
        if hasattr(node, a)
    ]


@dataclasses.dataclass(frozen=True)
class PhysicalPlan:
    root: PlanNode
    n_scans: int
    join_caps: tuple[int, ...]  # per join step, evaluation order

    def max_capacity(self) -> int:
        # the plan may be a DAG (union branches share the required chain);
        # id-dedup keeps the walk linear
        seen: set[int] = set()

        def walk(node: PlanNode) -> int:
            if id(node) in seen:
                return 0
            seen.add(id(node))
            return max(
                [node.capacity] + [walk(k) for k in child_nodes(node)]
            )

        return walk(self.root)


# -- shape (the cache key) ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """An OPTIONAL group: how many scans it consumes (in shape order, after
    the required chain and earlier groups) and its inner join structure."""

    n_scans: int
    cross_flags: tuple[bool, ...]  # len == n_scans - 1


@dataclasses.dataclass(frozen=True)
class PlanShape:
    """Everything a compiled program is specialised on, minus join caps.

    Pattern constants, filter constants and LIMIT/OFFSET values are
    deliberately absent: they only affect scan data / runtime inputs. Two
    queries with the same shape dispatch the same compiled executable.

    Scan order: required chain, then each OPTIONAL group's scans, then
    each UNION branch's scans. `filters` carry the optimizer's chosen
    attachment stage; `prune` enables projection narrowing (dropping
    variables nothing downstream reads) inside the compiled program.
    """

    scan_schemas: tuple[tuple[str, ...], ...]  # canonical names, plan order
    scan_caps: tuple[int, ...]
    cross_flags: tuple[bool, ...]  # required chain (len == n_required - 1)
    opt_groups: tuple[GroupSpec, ...] = ()
    union_groups: tuple[GroupSpec, ...] = ()
    has_required: bool = True  # False: UNION-only query, no required BGP
    filters: tuple[FilterSpec, ...] = ()
    n_consts: tuple[int, int] = (0, 0)  # (int, float) filter consts
    projection: tuple[str, ...] = ()  # canonical names
    distinct: bool = False
    has_slice: bool = False
    prune: bool = False  # optimizer projection pruning enabled
    # Physical algebra per join-cap slot ("mr" | "matrix"), evaluation
    # order, len == n_joins(). Part of the shape: a backend flip is a
    # different compiled program. Cross-join slots carry "mr" (unused).
    join_backends: tuple[str, ...] = ()
    # Per scan, the schema position the sharded store's rows are hash-
    # partitioned on (-1 = none; single-device shapes are all -1). Part of
    # the shape: the distributed lowering elides shuffles from it, so a
    # different partitioning is a different compiled program.
    scan_parts: tuple[int, ...] = ()

    @property
    def n_required(self) -> int:
        return len(self.cross_flags) + 1 if self.has_required else 0

    def n_joins(self) -> int:
        """Join steps that carry a calibrated bucket, evaluation order:
        required chain, per OPTIONAL group its inner joins + the left
        join, then per UNION branch its inner joins + (when a required
        chain exists) the branch-required join."""
        req = len(self.cross_flags) if self.has_required else 0
        opt = sum(len(g.cross_flags) + 1 for g in self.opt_groups)
        uni = sum(
            len(g.cross_flags) + (1 if self.has_required else 0)
            for g in self.union_groups
        )
        return req + opt + uni

    def slice_const_indices(self) -> tuple[int, int]:
        """(offset, limit) positions in the int runtime-constants array:
        appended right after the filter id constants."""
        base = self.n_consts[0]
        return base, base + 1


def canonical_renaming(
    schemas: tuple[tuple[str, ...], ...],
) -> dict[str, str]:
    """Original var -> ?cN by order of first appearance across the plan."""
    mapping: dict[str, str] = {}
    for schema in schemas:
        for v in schema:
            if v not in mapping:
                mapping[v] = f"?c{len(mapping)}"
    return mapping


def make_shape(
    scan_schemas: tuple[tuple[str, ...], ...],
    scan_caps: tuple[int, ...],
    cross_flags: tuple[bool, ...],
    projection: tuple[str, ...],
    distinct: bool,
    opt_groups: tuple[GroupSpec, ...] = (),
    union_groups: tuple[GroupSpec, ...] = (),
    has_required: bool = True,
    filters: tuple[FilterSpec, ...] = (),
    n_consts: tuple[int, int] = (0, 0),
    has_slice: bool = False,
    prune: bool = False,
    join_backends: tuple[str, ...] = (),
    scan_parts: tuple[int, ...] = (),
) -> PlanShape:
    n_group_scans = sum(g.n_scans for g in opt_groups)
    n_union_scans = sum(g.n_scans for g in union_groups)
    n_req = len(cross_flags) + 1 if has_required else 0
    assert has_required or not cross_flags
    assert has_required or not opt_groups
    assert len(scan_schemas) == len(scan_caps)
    assert len(scan_schemas) == n_req + n_group_scans + n_union_scans
    shape = PlanShape(
        scan_schemas,
        scan_caps,
        cross_flags,
        opt_groups,
        union_groups,
        has_required,
        filters,
        n_consts,
        projection,
        distinct,
        has_slice,
        prune,
    )
    # Normalise the backend and partitioning vectors so shapes differing
    # only in "explicit default" vs "omitted" compare (and hash) equal —
    # that equality is the plan-cache key.
    if not join_backends:
        join_backends = ("mr",) * shape.n_joins()
    assert len(join_backends) == shape.n_joins(), (join_backends, shape)
    assert all(b in ("mr", "matrix") for b in join_backends)
    if not scan_parts:
        scan_parts = (-1,) * len(scan_schemas)
    assert len(scan_parts) == len(scan_schemas), (scan_parts, scan_schemas)
    return dataclasses.replace(
        shape,
        join_backends=tuple(join_backends),
        scan_parts=tuple(scan_parts),
    )


def narrowed_schema(
    schema: tuple[str, ...], needed: set[str]
) -> tuple[str, ...]:
    return tuple(v for v in schema if v in needed)


def build_plan(shape: PlanShape, join_caps: tuple[int, ...]) -> PhysicalPlan:
    """Materialise the node tree for a shape at given join bucket capacities.

    `join_caps` are consumed in evaluation order: required-chain joins;
    per OPTIONAL group its inner joins then the left join; per UNION
    branch its inner joins then (when a required chain exists) the
    branch-required join. Filter conjuncts are interleaved at their
    optimizer-chosen stages, and (with shape.prune) intermediate schemas
    are narrowed to the variables something downstream still reads —
    projection pruning, applied inside the one compiled program.
    """
    assert len(join_caps) == shape.n_joins(), (join_caps, shape)
    caps = iter(join_caps)
    backends = iter(shape.join_backends or ("mr",) * shape.n_joins())
    effective: list[int] = []
    scan_idx = 0
    by_stage: dict[tuple, list[FilterExpr]] = {}
    for stage, expr in shape.filters:
        by_stage.setdefault(stage, []).append(expr)
    applied_stages: set[tuple] = set()

    def apply_filters(node: PlanNode, stage: tuple) -> PlanNode:
        applied_stages.add(stage)
        exprs = by_stage.get(stage)
        if exprs:
            node = Filter(node, tuple(exprs))
        return node

    def narrow(node: PlanNode, keep_joinable=()) -> PlanNode:
        """Project away variables nothing downstream reads: not in the
        final projection, not in a still-pending filter, not in a
        not-yet-consumed scan, and not in a schema we must stay joinable
        with (`keep_joinable`). Row counts are unaffected, so the
        calibration totals stay identical — only intermediate widths (and
        therefore join buffer bytes) shrink."""
        if not shape.prune:
            return node
        needed = set(shape.projection)
        for stage, expr in shape.filters:
            if stage not in applied_stages:
                needed.update(expr_vars(expr))
        for s in shape.scan_schemas[scan_idx:]:
            needed.update(s)
        for s in keep_joinable:
            needed.update(s)
        keep = narrowed_schema(node.schema, needed)
        if keep != tuple(node.schema):
            node = Project(node, keep)
        return node

    def next_scan() -> PlanNode:
        nonlocal scan_idx
        i = scan_idx
        part = shape.scan_parts[i] if shape.scan_parts else -1
        s = Scan(i, shape.scan_schemas[i], shape.scan_caps[i], part)
        scan_idx += 1
        return apply_filters(s, ("scan", i))

    def join_pair(
        node: PlanNode, right: PlanNode, is_cross: bool
    ) -> PlanNode:
        if is_cross:
            cap = node.capacity * right.capacity  # exact: see CrossJoin
            next(caps)  # consumes its slot, value is structural
            next(backends)  # cross joins have one algebra; slot is padding
            node = CrossJoin(
                node, right, tuple(node.schema) + tuple(right.schema), cap
            )
        else:
            cap = bucket_capacity(next(caps))
            key = tuple(v for v in node.schema if v in right.schema)
            extra = tuple(v for v in right.schema if v not in node.schema)
            cls = MatrixJoin if next(backends) == "matrix" else MRJoin
            node = cls(
                node, right, key, tuple(node.schema) + extra, cap
            )
        effective.append(cap)
        return node

    def chain(
        n_scans: int,
        cross_flags: tuple[bool, ...],
        req_stages: bool = False,
        keep_joinable=(),
    ) -> PlanNode:
        node = narrow(next_scan(), keep_joinable)
        for j, is_cross in enumerate(cross_flags):
            right = narrow(
                next_scan(), tuple(keep_joinable) + (node.schema,)
            )
            node = join_pair(node, right, is_cross)
            if req_stages:
                node = apply_filters(node, ("req", j))
            node = narrow(node, keep_joinable)
        return node

    node: PlanNode | None = None
    if shape.has_required:
        node = chain(shape.n_required, shape.cross_flags, req_stages=True)
    for gi, g in enumerate(shape.opt_groups):
        grp = chain(g.n_scans, g.cross_flags, keep_joinable=(node.schema,))
        key = tuple(v for v in node.schema if v in grp.schema)
        if not key:
            raise ValueError(
                "OPTIONAL group shares no variable with the required "
                f"patterns: {grp.schema} vs {node.schema}"
            )
        join_cap = bucket_capacity(next(caps))
        extra = tuple(v for v in grp.schema if v not in node.schema)
        node = LeftJoin(
            node, grp, key, tuple(node.schema) + extra, join_cap,
            backend=next(backends),
        )
        effective.append(join_cap)
        node = apply_filters(node, ("opt", gi))
        node = narrow(node)
    if shape.union_groups:
        req_node = node
        children: list[PlanNode] = []
        for bi, g in enumerate(shape.union_groups):
            keep = (req_node.schema,) if req_node is not None else ()
            bnode = chain(g.n_scans, g.cross_flags, keep_joinable=keep)
            if req_node is not None:
                shared = [v for v in req_node.schema if v in bnode.schema]
                bnode = join_pair(req_node, bnode, is_cross=not shared)
            bnode = apply_filters(bnode, ("bjoin", bi))
            bnode = narrow(bnode)
            children.append(bnode)
        schema: list[str] = []
        for c in children:
            for v in c.schema:
                if v not in schema:
                    schema.append(v)
        node = UnionAll(tuple(children), tuple(schema))
    node = apply_filters(node, ("top",))
    node = Project(node, shape.projection)
    if shape.distinct:
        node = Distinct(node)
    if shape.has_slice:
        off_idx, lim_idx = shape.slice_const_indices()
        node = Slice(node, off_idx, lim_idx)
    return PhysicalPlan(node, len(shape.scan_schemas), tuple(effective))


def grow_join_caps(
    join_caps: tuple[int, ...],
    totals: list[int],
    overflowed: list[bool],
) -> tuple[int, ...]:
    """Bucket-overflow fallback: resize flagged joins from their exact totals.

    `totals` are exact even when the join output was truncated (the count is
    computed before expansion), so one growth step is enough per flagged
    join; downstream joins that consumed a truncated input are re-checked on
    the retry dispatch.
    """
    new = list(join_caps)
    for i, flag in enumerate(overflowed):
        if flag:
            new[i] = bucket_capacity(max(int(totals[i]), 2 * join_caps[i]))
    return tuple(new)


# -- warmup persistence (plan-cache signatures as JSON) -----------------------


def _expr_from_json(e) -> FilterExpr:
    if e[0] == "cmp":
        return ("cmp", e[1], e[2], e[3], e[4])
    return (e[0], tuple(_expr_from_json(c) for c in e[1]))


def shape_to_jsonable(shape: PlanShape) -> dict:
    """A JSON-serialisable form of the cache key (tuples become lists; the
    inverse is `shape_from_jsonable`, which must round-trip to an equal
    PlanShape — that equality is what makes warmup hits possible)."""
    return {
        "scan_schemas": [list(s) for s in shape.scan_schemas],
        "scan_caps": list(shape.scan_caps),
        "cross_flags": list(shape.cross_flags),
        "opt_groups": [
            {"n_scans": g.n_scans, "cross_flags": list(g.cross_flags)}
            for g in shape.opt_groups
        ],
        "union_groups": [
            {"n_scans": g.n_scans, "cross_flags": list(g.cross_flags)}
            for g in shape.union_groups
        ],
        "has_required": shape.has_required,
        "filters": [[list(stage), expr] for stage, expr in shape.filters],
        "n_consts": list(shape.n_consts),
        "projection": list(shape.projection),
        "distinct": shape.distinct,
        "has_slice": shape.has_slice,
        "prune": shape.prune,
        "join_backends": list(shape.join_backends),
        "scan_parts": list(shape.scan_parts),
    }


def shape_from_jsonable(obj: dict) -> PlanShape:
    def group(d) -> GroupSpec:
        return GroupSpec(int(d["n_scans"]), tuple(d["cross_flags"]))

    shape = PlanShape(
        scan_schemas=tuple(tuple(s) for s in obj["scan_schemas"]),
        scan_caps=tuple(int(c) for c in obj["scan_caps"]),
        cross_flags=tuple(bool(f) for f in obj["cross_flags"]),
        opt_groups=tuple(group(g) for g in obj["opt_groups"]),
        union_groups=tuple(group(g) for g in obj["union_groups"]),
        has_required=bool(obj["has_required"]),
        filters=tuple(
            (tuple(stage), _expr_from_json(expr))
            for stage, expr in obj["filters"]
        ),
        n_consts=tuple(int(c) for c in obj["n_consts"]),
        projection=tuple(obj["projection"]),
        distinct=bool(obj["distinct"]),
        has_slice=bool(obj["has_slice"]),
        prune=bool(obj["prune"]),
    )
    # files predating the matrix backend carry no vector: all-MR
    backends = obj.get("join_backends")
    if backends is None:
        backends = ["mr"] * shape.n_joins()
    # files predating partitioning-aware lowering carry none: unpartitioned
    # (a sharded engine computes real parts, so such entries simply miss)
    parts = obj.get("scan_parts")
    if parts is None:
        parts = [-1] * len(shape.scan_schemas)
    return dataclasses.replace(
        shape,
        join_backends=tuple(backends),
        scan_parts=tuple(int(p) for p in parts),
    )
