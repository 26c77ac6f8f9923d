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


def execute_plan(
    plan: PhysicalPlan,
    scans: tuple[Relation, ...],
    consts_i: torch.Tensor,
    consts_f: torch.Tensor,
    num_vals: torch.Tensor,
) -> ChainResult:
    """Op-by-op interpretation without the plan cache — for tests."""
    return lower(plan)(scans, consts_i, consts_f, num_vals)
