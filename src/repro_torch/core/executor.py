"""Compiled executor: lower a PhysicalPlan to ONE device program.

The eager engine dispatches per join (count pass, host sync, expand pass).
This module instead lowers the whole plan tree — every MapReduce join, the
cross joins, OPTIONAL left joins, FILTER masks, projection, DISTINCT and
LIMIT/OFFSET — into a single function of the scan relations plus the
runtime constants.

A warm query is therefore exactly one dispatch of that program: one
uninterrupted stream of launches on the current CUDA stream, with no host
sync and no data-dependent shape inside it (static pow-2 capacities and
validity masks throughout). The per-join exact totals and overflow flags
ride back in the same dispatch, so the host's only synchronisation is
reading the flags afterwards; when a bucket overflowed, the engine grows it
(plan_ir.grow_join_caps) and rebuilds — the Mars double-on-overflow
discipline demoted to a rare fallback.

Runtime constants keep the cache hot across query variants: FILTER
comparison constants arrive as `consts_i` (term ids) / `consts_f` (numeric
values), LIMIT/OFFSET ride at the tail of `consts_i`, and `num_vals` is
the store's per-term numeric table — all plain inputs, none baked into the
program.

`compile_plan` is the only place a program is built, so ExecStats.n_compiles
is exact and tests can assert that a warm cache builds nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.core import matrix_join as mxj
from repro_torch.core import mr_join as mj
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
)
from repro_torch.core.relation import Relation


class ChainResult(NamedTuple):
    """Everything one dispatch returns (all device-resident)."""

    relation: Relation
    totals: torch.Tensor  # (n_joins,) exact per-join cardinality
    overflows: torch.Tensor  # (n_joins,) bool: join i truncated its output


def lower(plan: PhysicalPlan) -> Callable[..., ChainResult]:
    """Plan tree -> a function of (scans, consts_i, consts_f, num_vals).

    Join totals/overflows are collected in evaluation (post-)order: the
    required chain first, then each OPTIONAL group's inner joins followed
    by its left join — the order the engine calibrates join_caps in.
    """

    def run(
        scans: tuple[Relation, ...],
        consts_i: torch.Tensor,
        consts_f: torch.Tensor,
        num_vals: torch.Tensor,
    ) -> ChainResult:
        totals: list[torch.Tensor] = []
        flags: list[torch.Tensor] = []
        # The plan may be a DAG: UNION branches share the required-chain
        # subtree. Memoising by node identity evaluates the shared subtree
        # once, so its join totals/overflows are reported exactly once (in
        # first-visit order — the order the engine calibrates join_caps in).
        memo: dict[int, Relation] = {}

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
            if isinstance(node, (MRJoin, MatrixJoin)):
                left = eval_node(node.left)
                right = eval_node(node.right)
                join = (
                    mxj.matrix_join if isinstance(node, MatrixJoin)
                    else mj.mr_join
                )
                out, total, ovf = join(left, right, capacity=node.capacity)
                totals.append(total)
                flags.append(ovf)
                return out
            if isinstance(node, CrossJoin):
                left = eval_node(node.left)
                right = eval_node(node.right)
                out, total, ovf = mj.cross_join(
                    left, right, capacity=node.capacity
                )
                totals.append(total)
                flags.append(ovf)
                return mj.compact(out)
            if isinstance(node, LeftJoin):
                left = eval_node(node.left)
                right = eval_node(node.right)
                ljoin = (
                    mxj.matrix_left_join if node.backend == "matrix"
                    else mj.left_join
                )
                out, total, ovf = ljoin(left, right, capacity=node.join_cap)
                totals.append(total)
                flags.append(ovf)
                return out
            if isinstance(node, Filter):
                child = eval_node(node.child)
                keep = mj.filter_mask(
                    child, node.conds, consts_i, consts_f, num_vals
                )
                return Relation(child.schema, child.cols, keep)
            if isinstance(node, UnionAll):
                kids = [eval_node(c) for c in node.children]
                return mj.union_all(kids, node.schema)
            if isinstance(node, Project):
                return eval_node(node.child).project(list(node.schema))
            if isinstance(node, Distinct):
                return mj.distinct(eval_node(node.child))
            if isinstance(node, Slice):
                child = eval_node(node.child)
                return mj.slice_valid(
                    child,
                    consts_i[node.offset_index],
                    consts_i[node.limit_index],
                )
            raise TypeError(f"unknown plan node {node!r}")

        rel = eval_node(plan.root)
        dev = consts_i.device
        totals_arr = (
            torch.stack(totals) if totals
            else torch.zeros((0,), dtype=torch.int32, device=dev)
        )
        flags_arr = (
            torch.stack(flags) if flags
            else torch.zeros((0,), dtype=torch.bool, device=dev)
        )
        return ChainResult(rel, totals_arr, flags_arr)

    return run


def join_slot_nodes(plan: PhysicalPlan) -> list[PlanNode]:
    """The join nodes of a plan in slot order — the order `lower` appends
    their totals/overflow flags (post-order, shared DAG subtrees visited
    once, in first-visit order). EXPLAIN ANALYZE uses this to label each
    actuals slot with its physical operator; it MUST mirror `lower`'s
    traversal exactly or actuals would land on the wrong node."""
    slots: list[PlanNode] = []
    seen: set[int] = set()

    def walk(node: PlanNode) -> None:
        if id(node) in seen:
            return
        seen.add(id(node))
        for attr in ("left", "right", "child"):
            kid = getattr(node, attr, None)
            if kid is not None:
                walk(kid)
        for kid in getattr(node, "children", ()):
            walk(kid)
        if isinstance(node, (MRJoin, MatrixJoin, CrossJoin, LeftJoin)):
            slots.append(node)

    walk(plan.root)
    return slots


@dataclasses.dataclass
class CompiledPlan:
    """The lowered program for one (shape, join-caps) point."""

    plan: PhysicalPlan
    program: Callable[..., ChainResult]
    n_joins: int

    def __call__(
        self,
        scans: tuple[Relation, ...],
        consts_i: torch.Tensor,
        consts_f: torch.Tensor,
        num_vals: torch.Tensor,
    ) -> ChainResult:
        return self.program(scans, consts_i, consts_f, num_vals)


def compile_plan(plan: PhysicalPlan) -> CompiledPlan:
    """Build the program for the plan. It accepts any input tuple with the
    plan's schemas/capacities — i.e. every future query that hashes to the
    same PlanShape."""
    return CompiledPlan(plan, lower(plan), len(plan.join_caps))


# -- batched (stacked same-shape) execution -----------------------------------


def lower_batched(
    plan: PhysicalPlan,
    scan_axes: "tuple[int | None, ...] | None" = None,
) -> Callable[..., ChainResult]:
    """Stacked variant of `lower`: one dispatch executes a whole lane batch
    of same-shape queries.

    Every per-query runtime input — the scan relations, `consts_i`,
    `consts_f` — gains a leading lane axis; the store-wide `num_vals`
    table stays shared. A `(width,)` bool `lane_active` mask marks which
    lanes carry real queries: an inactive (padding) lane has its scan
    validity zeroed before anything else runs, so no operator downstream —
    join expansion, OPTIONAL unmatched-left padding, UNION concatenation —
    can emit a valid row for it, and its overflow flags are suppressed so
    padding can never trigger a bucket regrow.

    `scan_axes` is the per-scan lane axis: 0 for a stacked (width, cap,
    n_cols) buffer, None for a BROADCAST scan every lane shares — the
    same-query-different-FILTER batch ships each such scan's device buffer
    once instead of W stacked copies. Default: all stacked.

    Lanes need NOT stage at their natural scan capacities: cross-shape
    padded stacking (engine._coalesce_groups) runs near-miss PlanShapes —
    same plan DAG, smaller pow-2 scan caps — through one program by
    padding each lane's scans up to the group's max caps. Padding rows
    arrive valid=False, and every operator here is masked on validity, so
    a padded lane emits exactly the rows its natural shape would have.

    The batching is torch.func.vmap over the single-query program: plain
    torch ops batch by torch's rules, and each kernel op's vmap rule maps
    the batched call onto ONE launch of the kernel's stacked form, so a
    stacked dispatch launches each kernel once per join node, whatever the
    width.
    """
    base = lower(plan)
    axes = tuple(scan_axes) if scan_axes is not None else (0,) * plan.n_scans

    def run_lane(
        scans: tuple[Relation, ...],
        consts_i: torch.Tensor,
        consts_f: torch.Tensor,
        num_vals: torch.Tensor,
        active: torch.Tensor,
    ) -> ChainResult:
        masked = tuple(
            Relation(s.schema, s.cols, s.valid & active) for s in scans
        )
        rel, totals, flags = base(masked, consts_i, consts_f, num_vals)
        return ChainResult(rel, totals, flags & active)

    return torch.func.vmap(run_lane, in_dims=(axes, 0, 0, None, 0))


@dataclasses.dataclass
class CompiledBatch:
    """The width-W stacked program for one (shape, join-caps) point.

    Same specialisation as CompiledPlan plus the batch width and the
    per-scan stacked/broadcast layout: any group of <= W same-shape
    queries whose scans stack the same way dispatches through it
    (trailing lanes padded, masked inactive)."""

    plan: PhysicalPlan
    width: int
    program: Callable[..., ChainResult]
    scan_axes: "tuple[int | None, ...]" = ()

    def __call__(
        self,
        scans: tuple[Relation, ...],
        consts_i: torch.Tensor,
        consts_f: torch.Tensor,
        num_vals: torch.Tensor,
        lane_active: torch.Tensor,
    ) -> ChainResult:
        return self.program(scans, consts_i, consts_f, num_vals, lane_active)


def compile_plan_batched(
    plan: PhysicalPlan,
    width: int,
    scan_axes: "tuple[int | None, ...] | None" = None,
) -> CompiledBatch:
    """Build the stacked program at batch width `width` (scans at a None
    axis in `scan_axes` must arrive UNstacked, (cap, n_cols))."""
    if scan_axes is None:
        scan_axes = (0,) * plan.n_scans
    return CompiledBatch(
        plan, width, lower_batched(plan, scan_axes), tuple(scan_axes)
    )


def execute_plan(
    plan: PhysicalPlan,
    scans: tuple[Relation, ...],
    consts_i: torch.Tensor,
    consts_f: torch.Tensor,
    num_vals: torch.Tensor,
) -> ChainResult:
    """Op-by-op interpretation without the plan cache — for tests."""
    return lower(plan)(scans, consts_i, consts_f, num_vals)
