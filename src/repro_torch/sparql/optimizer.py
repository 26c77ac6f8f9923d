"""Cost-based query optimizer: rewrite passes over the logical algebra.

MapSQ's coprocessing strategy makes the CPU responsible for assigning
subqueries — i.e. planning. This module is that planner, grown from the
constant-free greedy heuristic in core/planner.py into a statistics-driven
pipeline (the step gSMat/gSmart show separates a reproduction from a
competitive engine). `optimize()` runs an ordered sequence of passes over
a parsed query's algebra and emits an `OptimizedProgram` — the scan
orders, filter attachment stages and cardinality estimates the engine
lowers to a physical plan:

  1. join_order        — statistics-backed greedy join ordering. Leaf
       cardinalities are the store's exact per-pattern match counts; join
       selectivities come from the StoreStatistics catalog (per-predicate
       triple counts and distinct-subject/object counts) via the System-R
       estimate |L ⋈ R| ≈ |L|·|R| / Π_v max(d_L(v), d_R(v)). Every pattern
       is tried as the chain head (left-deep greedy from each start) and
       the order minimising (max, sum) of estimated intermediate sizes
       wins — that is what keeps MR-join buckets small.
  2. filter_pushdown   — each FILTER conjunct sinks to the deepest sound
       stage: onto a single scan, after the earliest required-chain join
       binding its variables, after an OPTIONAL left join (never *into*
       the optional side — that would turn filtered-out rows into
       unmatched-but-kept rows), or distributed into every UNION branch.
  3. projection_prune  — variables nothing downstream needs (not
       projected, not filtered, bound by exactly one pattern) are marked
       prunable; the physical plan drops them before they widen
       intermediate relations (plan_ir.build_plan narrowing).

The passes record a human-readable trace that PreparedQuery.explain()
prints, pass by pass, together with the per-node cardinality estimates.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

from repro_torch.core.planner import TriplePattern, plan_bgp
from repro_torch.sparql import algebra
from repro_torch.sparql.store import StoreStatistics, TripleStore

# filter attachment stages — see core/plan_ir.py FilterStage
Stage = tuple


def q_error(est: float, actual: float) -> float:
    """The cardinality model's q-error for one join node: the symmetric
    over/under-estimation factor max(est/actual, actual/est), the metric
    EXPLAIN ANALYZE reports beside estimated-vs-actual rows. Defined as
    1.0 when both sides are zero (a perfect empty estimate) and inf when
    exactly one side is zero."""
    e, a = max(0.0, float(est)), max(0.0, float(actual))
    if e == 0.0 and a == 0.0:
        return 1.0
    if e == 0.0 or a == 0.0:
        return math.inf
    return max(e / a, a / e)


@dataclasses.dataclass(frozen=True)
class OptimizedProgram:
    """The optimizer's output: everything the engine lowers to a PlanShape.

    Scan order is required chain, then each OPTIONAL group, then each
    UNION branch; `filters` pair every conjunct with its attachment stage
    (a conjunct distributed into UNION branches appears once per branch);
    `join_ests` align with the physical plan's join-capacity slots in
    evaluation order.
    """

    required: tuple[TriplePattern, ...]
    cross_flags: tuple[bool, ...]
    opt_groups: tuple[tuple[TriplePattern, ...], ...]
    opt_cross_flags: tuple[tuple[bool, ...], ...]
    branches: tuple[tuple[TriplePattern, ...], ...]
    branch_cross_flags: tuple[tuple[bool, ...], ...]
    filters: tuple[tuple[Stage, algebra.FilterExpr], ...]
    join_ests: tuple[float, ...]
    # physical algebra per join slot ("mr" | "matrix"), aligned with
    # join_ests; cross slots always carry "mr"
    join_backends: tuple[str, ...]
    prune: bool
    trace: tuple[str, ...]

    @property
    def has_required(self) -> bool:
        return bool(self.required)

    def all_patterns(self) -> tuple[TriplePattern, ...]:
        """Every scan in plan order (required, optionals, branches)."""
        out = list(self.required)
        for g in self.opt_groups:
            out.extend(g)
        for b in self.branches:
            out.extend(b)
        return tuple(out)


# -- cardinality / selectivity model ------------------------------------------


@dataclasses.dataclass
class _State:
    """Estimated intermediate: row count, per-variable distinct counts and
    per-variable degree skew (max/avg join fan-out of the predicate
    position that bound the variable — the matrix backend's signal).

    `schema` is the relation's column order (the physical plan derives
    each join key from it, so the optimizer can mirror the lowering's key
    exactly); `part` is the hash-partitioning columns under a sharded
    store (None = unknown placement) — the host-side mirror of
    core/dist_executor's Partitioning property, driving the shuffle-cost
    term of the join ordering."""

    card: float
    dv: dict[str, float]
    skew: dict[str, float] = dataclasses.field(default_factory=dict)
    schema: tuple[str, ...] = ()
    part: "tuple[str, ...] | None" = None


def _filter_selectivity(expr: algebra.FilterExpr, dv: dict[str, float]) -> float:
    """Textbook selectivity of a pushed filter over a single pattern:
    `=` 1/distinct, range comparisons 1/3, `!=` 1 (conservative), `&&`
    multiplies, `||` adds (clamped)."""
    if isinstance(expr, algebra.Compare):
        if expr.op == "=":
            return 1.0 / max(1.0, dv.get(expr.lhs, 1.0))
        if expr.op == "!=":
            return 1.0
        return 1.0 / 3.0
    sels = [_filter_selectivity(c, dv) for c in expr.children]
    if isinstance(expr, algebra.And):
        return math.prod(sels)
    return min(1.0, sum(sels))


def _pattern_state(
    tp: TriplePattern,
    leaf_card: Callable[[TriplePattern], float],
    stats: StoreStatistics,
    lookup,
    filters: Sequence[algebra.FilterExpr] = (),
) -> _State:
    card = float(leaf_card(tp))
    dv = {
        v: max(1.0, min(stats.distinct_values(tp, v, lookup), card))
        for v in tp.variables()
    }
    skew: dict[str, float] = {}
    ps = None
    if not tp.p.startswith("?"):
        pid = lookup(tp.p)
        ps = stats.predicates.get(pid) if pid is not None else None
    for v in tp.variables():
        if ps is not None and v == tp.s:
            skew[v] = ps.s_skew
        elif ps is not None and v == tp.o:
            skew[v] = ps.o_skew
        else:
            skew[v] = 1.0
    # fold pushed-filter selectivity into the leaf estimate: a filter whose
    # variables the pattern binds will mask the scan before it joins, so
    # the join ordering should see the filtered cardinality
    tp_vars = set(tp.variables())
    for expr in filters:
        if tp_vars and set(expr.variables()) <= tp_vars:
            card *= _filter_selectivity(expr, dv)
    dv = {v: max(1.0, min(d, card)) for v, d in dv.items()}
    # scan-order column schema (s,p,o first appearance — the store's scan
    # column order); a variable subject means the sharded store hands this
    # scan out already subject-hash partitioned
    schema = tuple(dict.fromkeys(tp.variables()))
    part = (tp.s,) if tp.s.startswith("?") else None
    return _State(card, dv, skew, schema, part)


def _join_states(a: _State, b: _State) -> tuple[_State, bool]:
    """System-R style join estimate; returns (joined state, shared?)."""
    shared = set(a.dv) & set(b.dv)
    denom = 1.0
    for v in shared:
        denom *= max(a.dv[v], b.dv[v], 1.0)
    est = a.card * b.card / denom
    dv = {}
    for v in set(a.dv) | set(b.dv):
        d = min(a.dv.get(v, math.inf), b.dv.get(v, math.inf))
        dv[v] = max(1.0, min(d, est)) if est > 0 else 1.0
    skew = {
        v: max(a.skew.get(v, 1.0), b.skew.get(v, 1.0))
        for v in set(a.skew) | set(b.skew)
    }
    schema = a.schema + tuple(v for v in b.schema if v not in a.schema)
    return _State(est, dv, skew, schema), bool(shared)


# -- backend selection: MR join vs matrix (masked SpMM) join ------------------

# choose "matrix" when selectivity x skew says the join output is within a
# constant factor of the dense |L| x |R| compare grid the matrix backend
# walks: there the MR backend's two argsorts are pure overhead, while a hot
# (skewed) key makes its expansion scale with the dense product anyway
MATRIX_THRESHOLD = 0.5
# never go dense past this |L| x |R| work bound, whatever the skew
MATRIX_DENSE_CAP = 1 << 22


def _choose_backend(a: _State, b: _State, est: float) -> str:
    shared = set(a.dv) & set(b.dv)
    if not shared:
        return "mr"  # cross join: one algebra, slot value is padding
    work = a.card * b.card
    if work <= 0 or work > MATRIX_DENSE_CAP:
        return "mr"
    sigma = est / work
    skew = max(max(a.skew.get(v, 1.0), b.skew.get(v, 1.0)) for v in shared)
    return "matrix" if sigma * skew >= MATRIX_THRESHOLD else "mr"


def _dist_step(
    a: _State, b: _State, n_shards: int
) -> tuple[float, "tuple[str, ...] | None"]:
    """Shuffle cost of the sharded join a ⋈ b: (estimated rows moved
    between shards, output partitioning). Mirrors the strategy rules of
    core/dist_executor.analyze_plan on the estimates: an aligned side
    moves nothing; a misaligned side shuffles card × (n-1)/n rows; a
    small doubly-misaligned right side broadcasts (card × (n-1)) and the
    left partitioning survives. Zero at n_shards == 1, so single-device
    join ordering is unchanged."""
    key = tuple(v for v in a.schema if v in set(b.schema))
    if n_shards <= 1:
        return 0.0, (key or a.part)
    if not key:  # cross join: the right side is replicated
        return b.card * (n_shards - 1), a.part
    left_ok = a.part == key
    right_ok = b.part == key
    if left_ok and right_ok:
        return 0.0, key
    if (
        not left_ok
        and not right_ok
        and b.card * n_shards <= _BROADCAST_ROWS
    ):
        return b.card * (n_shards - 1), a.part
    frac = (n_shards - 1) / n_shards
    moved = (0.0 if left_ok else a.card) + (0.0 if right_ok else b.card)
    return moved * frac, key


# mirrors core/dist_executor.DEFAULT_BROADCAST_ROWS (kept as a literal so
# the optimizer stays importable without the executor stack; the actual
# broadcast decision is re-made from real capacities at lowering time —
# this copy only shapes the cost model)
_BROADCAST_ROWS = 2048


def _greedy_from(
    states: list[_State], start: int, n_shards: int = 1
) -> tuple[
    list[int], list[bool], list[float], list[str], _State, list[float]
]:
    """Left-deep greedy order from a fixed head, minimising each next
    join's estimated output PLUS its shuffle cost (rows moved between
    shards — zero at n_shards == 1, so single-device ordering is
    bit-identical). Cross joins go last, smallest first. Also returns the
    per-step costs (est + moved) the start-selection compares."""
    order = [start]
    flags: list[bool] = []
    ests: list[float] = []
    costs: list[float] = []
    backends: list[str] = []
    cur = states[start]
    remaining = [i for i in range(len(states)) if i != start]

    def step_cost(i: int) -> float:
        new, _ = _join_states(cur, states[i])
        moved, _ = _dist_step(cur, states[i], n_shards)
        return new.card + moved

    while remaining:
        connected = [
            i for i in remaining if set(states[i].dv) & set(cur.dv)
        ]
        if connected:
            nxt = min(connected, key=lambda i: (step_cost(i), i))
        else:  # disconnected component: cheapest pattern first
            nxt = min(remaining, key=lambda i: (states[i].card, i))
        new, shared = _join_states(cur, states[nxt])
        moved, out_part = _dist_step(cur, states[nxt], n_shards)
        new.part = out_part
        order.append(nxt)
        flags.append(not shared)
        ests.append(new.card)
        costs.append(new.card + moved)
        backends.append(_choose_backend(cur, states[nxt], new.card))
        cur = new
        remaining.remove(nxt)
    return order, flags, ests, backends, cur, costs


# starts tried exhaustively up to this many patterns (n × O(n²) greedy
# runs); beyond it, fall back to the single min-cardinality start
_MAX_EXHAUSTIVE_STARTS = 10


def order_patterns(
    patterns: Sequence[TriplePattern],
    leaf_card: Callable[[TriplePattern], float],
    stats: StoreStatistics,
    lookup,
    filters: Sequence[algebra.FilterExpr] = (),
    n_shards: int = 1,
) -> tuple[
    list[int], tuple[bool, ...], list[float], list[str], _State,
    list[float],
]:
    """Statistics-backed join ordering for one BGP.

    Tries every pattern as the chain head and keeps the greedy order with
    the smallest (max, sum) of per-step COSTS — estimated intermediate
    cardinality plus, when `n_shards` > 1, the shuffle term (rows moved ×
    (n_shards-1)/n_shards), which steers toward alignment-preserving
    orders (a subject-star chain keeps every join map-side). At
    n_shards == 1 cost == cardinality, so single-device plans are
    unchanged. Deterministic for a given store, so structurally-equal
    queries keep hashing to one PlanShape. `filters` (the query's FILTER
    conjuncts) sharpen the leaf estimates: a conjunct a single pattern
    binds is treated as a scan-stage mask, scaling that leaf by its
    selectivity. Also returns the per-step shuffle cost (cost − est) for
    the trace.
    """
    states = [
        _pattern_state(tp, leaf_card, stats, lookup, filters)
        for tp in patterns
    ]
    if len(patterns) == 1:
        return [0], (), [], [], states[0], []
    if len(patterns) <= _MAX_EXHAUSTIVE_STARTS:
        starts = range(len(patterns))
    else:
        starts = [min(range(len(patterns)), key=lambda i: states[i].card)]
    best = None
    for s in starts:
        order, flags, ests, backends, final, costs = _greedy_from(
            states, s, n_shards
        )
        key = (max(costs), sum(costs), tuple(order))
        if best is None or key < best[0]:
            best = (key, order, flags, ests, backends, final, costs)
    _, order, flags, ests, backends, final, costs = best
    moved = [c - e for c, e in zip(costs, ests)]
    return order, tuple(flags), ests, backends, final, moved


# -- the pass pipeline --------------------------------------------------------


def _fmt_tp(tp: TriplePattern) -> str:
    return f"({tp.s} {tp.p} {tp.o})"


def _fmt_est(x: float) -> str:
    return str(int(x)) if x < 1e15 else f"{x:.2e}"


def _order_bgp(
    patterns: Sequence[TriplePattern],
    store: TripleStore,
    enabled: bool,
    label: str,
    trace: list[str],
    filters: Sequence[algebra.FilterExpr] = (),
    n_shards: int = 1,
) -> tuple[
    list[TriplePattern], tuple[bool, ...], list[float], list[str], _State
]:
    """One BGP through the join_order pass (or the legacy greedy)."""
    leaf = store.estimate_cardinality
    lookup = store.dictionary.lookup
    if not enabled:
        steps = plan_bgp(patterns, leaf)
        ordered = [patterns[st.pattern_index] for st in steps]
        flags = tuple(st.is_cross for st in steps[1:])
        # estimates still reported for explain(), just not acted on; the
        # legacy path always lowers to the MR backend
        states = [
            _pattern_state(tp, leaf, store.statistics, lookup)
            for tp in ordered
        ]
        cur, ests = states[0], []
        for st in states[1:]:
            cur, _ = _join_states(cur, st)
            ests.append(cur.card)
        return ordered, flags, ests, ["mr"] * len(ests), cur
    order, flags, ests, backends, final, moved = order_patterns(
        patterns, leaf, store.statistics, lookup, filters, n_shards
    )
    ordered = [patterns[i] for i in order]
    trace.append(
        f"join_order[{label}]: "
        + " -> ".join(_fmt_tp(tp) for tp in ordered)
        + (
            "  est rows per join: ["
            + ", ".join(_fmt_est(e) for e in ests)
            + "]"
            if ests
            else ""
        )
    )
    if n_shards > 1 and moved:
        trace.append(
            f"shuffle_cost[{label}]: est rows moved per join "
            f"({n_shards} shards): ["
            + ", ".join(_fmt_est(m) for m in moved)
            + "]"
            + (
                ""
                if any(m > 0 for m in moved)
                else "  (all joins map-side)"
            )
        )
    if "matrix" in backends:
        picked = [i for i, b in enumerate(backends) if b == "matrix"]
        trace.append(
            f"join_backend[{label}]: matrix join at step(s) "
            + ", ".join(str(i) for i in picked)
            + " (selectivity x skew >= threshold)"
        )
    return ordered, flags, ests, backends, final


def _validate_optionals(
    q, required_vars: set[str]
) -> None:
    """The engine's OPTIONAL soundness rules, enforced at plan time."""
    opt_bound: set[str] = set()
    for group in q.optionals:
        gvars = {v for tp in group for v in tp.variables()}
        overlap = gvars & opt_bound
        if overlap:
            raise ValueError(
                "unsupported: OPTIONAL group reuses variable(s) bound "
                f"by an earlier OPTIONAL group: {sorted(overlap)} "
                "(unbound-compatible chained-OPTIONAL semantics are "
                "not implemented)"
            )
        if not (gvars & required_vars):
            raise ValueError(
                "OPTIONAL group shares no variable with the required "
                f"patterns: {sorted(gvars)}"
            )
        opt_bound |= gvars - required_vars


def _attach_filters(
    q,
    required: Sequence[TriplePattern],
    opt_groups: Sequence[Sequence[TriplePattern]],
    branches: Sequence[Sequence[TriplePattern]],
    enabled: bool,
    trace: list[str],
) -> tuple[tuple[Stage, algebra.FilterExpr], ...]:
    """filter_pushdown: sink each conjunct to its deepest sound stage."""
    if not q.filters:
        return ()
    if not enabled:
        return tuple((("top",), expr) for expr in q.filters)
    req_scan_vars = [set(tp.variables()) for tp in required]
    req_all: set[str] = set().union(*req_scan_vars) if required else set()
    acc: set[str] = set(req_scan_vars[0]) if required else set()
    acc_after_join: list[set[str]] = []
    for s in req_scan_vars[1:]:
        acc = acc | s
        acc_after_join.append(set(acc))
    group_vars = [
        {v for tp in g for v in tp.variables()} for g in opt_groups
    ]
    branch_scan_vars = [
        [set(tp.variables()) for tp in b] for b in branches
    ]
    branch_vars = [set().union(*bs) for bs in branch_scan_vars]
    n_req = len(required)
    n_opt = sum(len(g) for g in opt_groups)
    branch_scan_base = []
    base = n_req + n_opt
    for b in branches:
        branch_scan_base.append(base)
        base += len(b)

    def required_stage(v: set[str]) -> Stage | None:
        """Deepest required-chain stage binding all of `v`, or None."""
        if not required or not v <= req_all:
            return None
        for i, sv in enumerate(req_scan_vars):
            if v <= sv:
                return ("scan", i)
        for j, av in enumerate(acc_after_join):
            if v <= av:
                return ("req", j)
        return None  # unreachable: acc_after_join[-1] == req_all

    specs: list[tuple[Stage, algebra.FilterExpr]] = []
    for expr in q.filters:
        v = set(expr.variables())
        stage = required_stage(v)
        if stage is not None:
            # bound by the required chain (which, with UNION, every
            # branch joins through) — attach inside the chain
            specs.append((stage, expr))
        elif branches and all(
            v <= req_all | bv for bv in branch_vars
        ):
            # distribute a copy into every branch (dropping it from the
            # top is only sound if each branch enforces it)
            stages = []
            for b, bs in enumerate(branch_scan_vars):
                st: Stage = ("bjoin", b)
                for i, sv in enumerate(bs):
                    if v <= sv:
                        st = ("scan", branch_scan_base[b] + i)
                        break
                stages.append(st)
                specs.append((st, expr))
            trace.append(
                f"filter_pushdown: ({expr}) distributed into "
                f"{len(stages)} UNION branch(es)"
            )
            continue
        elif opt_groups and v - req_all:
            needed = [
                g for g, gv in enumerate(group_vars) if (v - req_all) & gv
            ]
            if needed and (v - req_all) <= set().union(
                *(group_vars[g] for g in needed)
            ):
                stage = ("opt", max(needed))
                specs.append((stage, expr))
            else:
                stage = ("top",)
                specs.append((stage, expr))
        else:
            stage = ("top",)
            specs.append((stage, expr))
        if stage is not None:
            trace.append(
                f"filter_pushdown: ({expr}) -> {_fmt_stage(stage)}"
            )
    return tuple(specs)


def _fmt_stage(stage: Stage) -> str:
    kind = stage[0]
    if kind == "scan":
        return f"scan[{stage[1]}]"
    if kind == "req":
        return f"after join[{stage[1]}]"
    if kind == "opt":
        return f"after left_join[{stage[1]}]"
    if kind == "bjoin":
        return f"after union branch[{stage[1]}] join"
    return "top (unpushed)"


def _prune_trace(
    q,
    all_patterns: Sequence[TriplePattern],
    specs,
    trace: list[str],
) -> None:
    """projection_prune: report the variables the physical plan will drop
    early (bound by exactly one pattern, not projected, not filtered —
    plan_ir.build_plan performs the actual narrowing)."""
    from collections import Counter

    uses = Counter(
        v for tp in all_patterns for v in set(tp.variables())
    )
    keep = set(q.projection())
    for _, expr in specs:
        keep.update(expr.variables())
    dead = sorted(
        v for v, n in uses.items() if n == 1 and v not in keep
    )
    if dead:
        trace.append(
            "projection_prune: dropping "
            + ", ".join(dead)
            + " before they widen intermediates"
        )


def optimize(
    q, store: TripleStore, enabled: bool = True, n_shards: int = 1
) -> OptimizedProgram:
    """Run the pass pipeline over a parsed query.

    `enabled=False` reproduces the pre-optimizer behaviour (legacy greedy
    join order, every join on the MR backend, all filters evaluated at the
    top, no pruning): the baseline the J1/J2 comparisons measure against.
    `n_shards` > 1 (the sharded engine) adds the per-step shuffle-cost term
    to the join ordering — movement between shards the plan can avoid by
    keeping joins on already-aligned keys."""
    trace: list[str] = []
    required_vars = {v for tp in q.patterns for v in tp.variables()}
    _validate_optionals(q, required_vars)

    join_ests: list[float] = []
    join_backends: list[str] = []
    est_filters = tuple(q.filters) if enabled else ()
    req_state: _State | None = None
    if q.patterns:
        required, cross_flags, ests, bks, req_state = _order_bgp(
            q.patterns, store, enabled, "required", trace, est_filters,
            n_shards,
        )
        join_ests.extend(ests)
        join_backends.extend(bks)
    else:
        required, cross_flags = [], ()

    opt_groups: list[tuple[TriplePattern, ...]] = []
    opt_cross_flags: list[tuple[bool, ...]] = []
    for gi, group in enumerate(q.optionals):
        ordered, flags, ests, bks, g_state = _order_bgp(
            list(group), store, enabled, f"optional[{gi}]", trace,
            est_filters, n_shards,
        )
        opt_groups.append(tuple(ordered))
        opt_cross_flags.append(flags)
        join_ests.extend(ests)
        join_backends.extend(bks)
        joined, _ = _join_states(req_state, g_state)
        join_ests.append(joined.card)  # the left join's inner-join bucket
        join_backends.append(
            _choose_backend(req_state, g_state, joined.card)
            if enabled
            else "mr"
        )

    branches: list[tuple[TriplePattern, ...]] = []
    branch_cross_flags: list[tuple[bool, ...]] = []
    for bi, branch in enumerate(q.unions):
        ordered, flags, ests, bks, b_state = _order_bgp(
            list(branch), store, enabled, f"union[{bi}]", trace,
            est_filters, n_shards,
        )
        branches.append(tuple(ordered))
        branch_cross_flags.append(flags)
        join_ests.extend(ests)
        join_backends.extend(bks)
        if req_state is not None:
            joined, _ = _join_states(req_state, b_state)
            join_ests.append(joined.card)
            join_backends.append(
                _choose_backend(req_state, b_state, joined.card)
                if enabled
                else "mr"
            )

    specs = _attach_filters(
        q, required, opt_groups, branches, enabled, trace
    )
    if enabled:
        _prune_trace(
            q,
            list(required)
            + [tp for g in opt_groups for tp in g]
            + [tp for b in branches for tp in b],
            specs,
            trace,
        )
    else:
        trace.append("optimizer disabled: legacy greedy order, filters at top")
    return OptimizedProgram(
        required=tuple(required),
        cross_flags=tuple(cross_flags),
        opt_groups=tuple(opt_groups),
        opt_cross_flags=tuple(opt_cross_flags),
        branches=tuple(branches),
        branch_cross_flags=tuple(branch_cross_flags),
        filters=specs,
        join_ests=tuple(join_ests),
        join_backends=tuple(join_backends),
        prune=enabled,
        trace=tuple(trace),
    )
