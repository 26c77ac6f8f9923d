"""Algorithm 1 of MapSQ: the MapReduce-based join, in PyTorch.

Three phases, exactly as the paper structures them:

  Map             — split every tuple into (key, value); tag side. Invalid
                    (padding) rows are mapped to per-side sentinel keys so
                    they can never join.
  Sort            — sort both sides by key (the shuffle), with a STABLE
                    sort: equal keys keep buffer order, which fixes the
                    emission order the matrix backend reproduces bit for bit.
  ReduceDuplicate — per key group, emit the cartesian product of LEFT values
                    with RIGHT values: per-left-row match counts via binary
                    search, prefix sum, then the dense inverse-prefix-sum
                    gather of kernels/pair_expand — one output slot per
                    thread, load balanced whatever the skew.

Dynamic result size is handled Mars-style: a count pass returns the exact
total; the expand pass fills a static-capacity buffer with a validity mask.
Nothing here syncs with the device or has a data-dependent shape, so a whole
plan of these operators runs as one uninterrupted stream of launches.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.relation import (
    INVALID_LEFT,
    INVALID_RIGHT,
    UNBOUND,
    Relation,
    shared_vars,
)
from repro_torch.core.segments import dense_rank_two_sided, first_row, lexsort
from repro_torch.kernels.pair_expand import ops as pe_ops

_I32 = torch.int32


class JoinPlanArrays(NamedTuple):
    """Sorted intermediates shared by the count and expand passes."""

    order_l: torch.Tensor  # (n_l,) permutation sorting left by key
    order_r: torch.Tensor  # (n_r,) permutation sorting right by key
    lo: torch.Tensor  # (n_l,) first matching right slot per sorted-left row
    counts: torch.Tensor  # (n_l,) number of right matches per sorted-left row
    prefix: torch.Tensor  # (n_l,) inclusive prefix sum of counts
    total: torch.Tensor  # () int32 exact number of join results


def _map_phase(left: Relation, right: Relation, key_vars: list[str]):
    """Map: extract key columns, tag sides via sentinels on invalid rows."""
    lk = torch.stack([left.column(v) for v in key_vars], dim=1)
    rk = torch.stack([right.column(v) for v in key_vars], dim=1)
    lk = lk.masked_fill(~left.valid[:, None], int(INVALID_LEFT))
    rk = rk.masked_fill(~right.valid[:, None], int(INVALID_RIGHT))
    if len(key_vars) == 1:
        return lk[:, 0].contiguous(), rk[:, 0].contiguous()
    # Multi-variable join: dense-rank tuples jointly so binary search works
    # on a single int32 key. Sentinel rows keep never-equal ranks.
    return dense_rank_two_sided(lk, rk)


def _stable_argsort(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, stable=True).indices.to(_I32)


def _sort_count_phase(l_key: torch.Tensor, r_key: torch.Tensor) -> JoinPlanArrays:
    """Sort + the counting half of ReduceDuplicate (Mars pass 1)."""
    order_l = _stable_argsort(l_key)
    order_r = _stable_argsort(r_key)
    lk_sorted = l_key[order_l]
    rk_sorted = r_key[order_r]
    lo = torch.searchsorted(rk_sorted, lk_sorted, out_int32=True)
    hi = torch.searchsorted(rk_sorted, lk_sorted, right=True, out_int32=True)
    counts = hi - lo
    prefix = torch.cumsum(counts, dim=0, dtype=_I32)
    if counts.shape[0]:
        total = prefix[-1]
    else:
        total = torch.zeros((), dtype=_I32, device=counts.device)
    return JoinPlanArrays(order_l, order_r, lo, counts, prefix, total)


def expand_pairs(plan: JoinPlanArrays, capacity: int):
    """Inverse-prefix-sum expansion: for output slot t, the left sorted-row
    i = first index with prefix[i] > t, its offset within the group
    t - (prefix[i] - counts[i]), and the right sorted-row lo[i] + offset."""
    i, off, valid = pe_ops.pair_expand(plan.prefix, plan.counts, capacity)
    j = plan.lo[i] + off
    li = plan.order_l[i]
    rj = plan.order_r[j.clamp(0, plan.order_r.shape[0] - 1)]
    return li, rj, valid


def mr_join_plan(left: Relation, right: Relation) -> tuple[JoinPlanArrays, list[str]]:
    key_vars = shared_vars(left, right)
    if not key_vars:
        raise ValueError(
            f"cross join between {left.schema} and {right.schema}; use cross_join()"
        )
    l_key, r_key = _map_phase(left, right, key_vars)
    return _sort_count_phase(l_key, r_key), key_vars


def mr_join_count(left: Relation, right: Relation) -> torch.Tensor:
    """Mars pass 1: the exact result cardinality (O(n log n))."""
    plan, _ = mr_join_plan(left, right)
    return plan.total


def _expanded_cols(left, right, li, rj, valid, capacity):
    right_extra = [v for v in right.schema if v not in left.schema]
    out_schema = tuple(left.schema) + tuple(right_extra)
    l_cols = left.cols[li]
    if right_extra:
        r_cols = right.project(right_extra).cols[rj]
    else:
        r_cols = torch.zeros((capacity, 0), dtype=_I32, device=left.device)
    cols = torch.cat([l_cols, r_cols], dim=1)
    return out_schema, right_extra, cols.masked_fill(~valid[:, None], 0)


def mr_join(
    left: Relation,
    right: Relation,
    capacity: int,
) -> tuple[Relation, torch.Tensor, torch.Tensor]:
    """Full Algorithm 1. Returns (result, exact_total, overflowed).

    Output schema: all left vars, then right vars not already bound.
    `capacity` is static; rows past `exact_total` are masked invalid. If
    exact_total > capacity the result is truncated and overflowed=True —
    the engine re-runs with a larger capacity (Mars two-pass).
    """
    plan, _ = mr_join_plan(left, right)
    li, rj, valid = expand_pairs(plan, capacity)
    out_schema, _, cols = _expanded_cols(left, right, li, rj, valid, capacity)
    return Relation(out_schema, cols, valid), plan.total, plan.total > capacity


def left_join(
    left: Relation,
    right: Relation,
    capacity: int,
) -> tuple[Relation, torch.Tensor, torch.Tensor]:
    """OPTIONAL as Algorithm 1 plus unmatched-left padding.

    The first `capacity` output slots hold the inner-join result; the
    trailing `left.capacity` slots hold the left rows with no right match,
    their right-only columns set to the UNBOUND sentinel (so the padding
    part can never overflow). Returns (result, join_total, join_overflowed)
    where the total/overflow describe only the inner-join part — that is
    the bucket the engine calibrates and grows.
    """
    plan, _ = mr_join_plan(left, right)
    li, rj, valid = expand_pairs(plan, capacity)
    out_schema, right_extra, join_cols = _expanded_cols(
        left, right, li, rj, valid, capacity
    )
    # unmatched-left padding (the semijoin mask, inverted)
    unmatched = left.valid & ~_matched_left_mask(plan, left)
    pad = torch.full(
        (left.capacity, len(right_extra)), int(UNBOUND), dtype=_I32,
        device=left.device,
    )
    cols = torch.cat([join_cols, torch.cat([left.cols, pad], dim=1)], dim=0)
    valid_all = torch.cat([valid, unmatched])
    return Relation(out_schema, cols, valid_all), plan.total, plan.total > capacity


def cross_join(
    left: Relation, right: Relation, capacity: int
) -> tuple[Relation, torch.Tensor, torch.Tensor]:
    """Cartesian product for disconnected BGP components (no shared vars)."""
    n_r = right.capacity
    t = torch.arange(capacity, dtype=_I32, device=left.device)
    # slots past left.capacity * n_r are masked invalid; their gathers are
    # clamped to the last row, as the reference's out-of-range reads are
    li = (t // n_r).clamp(max=left.capacity - 1)
    rj = t % n_r
    valid = left.valid[li] & right.valid[rj] & (t < left.capacity * n_r)
    cols = torch.cat([left.cols[li], right.cols[rj]], dim=1)
    total = left.count() * right.count()
    # totals are exact but positions are not compacted: mask handles padding
    # interleaved with real rows; compact() can be applied afterwards.
    out = Relation(tuple(left.schema) + tuple(right.schema), cols, valid)
    return out, total, total > capacity


def compact(rel: Relation) -> Relation:
    """Stable-move valid rows to the front (static-shape compaction)."""
    order = torch.sort((~rel.valid).to(torch.uint8), stable=True).indices
    return Relation(rel.schema, rel.cols[order], rel.valid[order])


def distinct(rel: Relation) -> Relation:
    """Mask duplicate rows (used for SELECT DISTINCT / projections)."""
    # Sort rows lexicographically with validity as the final tiebreak so all
    # valid copies of a row are adjacent and precede invalid (padding) copies.
    keys = [(~rel.valid).to(_I32)] + [
        rel.cols[:, c] for c in reversed(range(rel.n_cols))
    ]
    perm = lexsort(keys)
    cols_s = rel.cols[perm]
    valid_s = rel.valid[perm]
    same_as_prev = (cols_s == torch.roll(cols_s, 1, dims=0)).all(dim=1)
    prev_valid = torch.roll(valid_s, 1) & ~first_row(valid_s)
    keep = valid_s & ~(same_as_prev & prev_valid)
    # scatter back to buffer order (perm is a permutation)
    return Relation(rel.schema, rel.cols, torch.empty_like(keep).scatter(0, perm, keep))


def _matched_left_mask(plan: JoinPlanArrays, left: Relation) -> torch.Tensor:
    """valid mask of left rows having >=1 right match, in buffer order
    (shared by semijoin_mask and left_join's unmatched padding)."""
    has = plan.counts > 0
    in_buffer_order = torch.empty_like(has).scatter(0, plan.order_l.long(), has)
    return left.valid & in_buffer_order


def semijoin_mask(left: Relation, right: Relation) -> torch.Tensor:
    """valid mask of left rows having >=1 match in right (for FILTER EXISTS)."""
    plan, _ = mr_join_plan(left, right)
    return _matched_left_mask(plan, left)


# -- FILTER masks and LIMIT/OFFSET (device-side, no host sync) ---------------

_NUMERIC_CMP = {
    "=": torch.eq,
    "!=": torch.ne,
    "<": torch.lt,
    "<=": torch.le,
    ">": torch.gt,
    ">=": torch.ge,
}


def _numeric_of(col: torch.Tensor, num_vals: torch.Tensor) -> torch.Tensor:
    """Gather per-row numeric values; UNBOUND/non-numeric terms become NaN."""
    safe = col.clamp(0, num_vals.shape[0] - 1)
    return num_vals[safe].masked_fill(col < 0, float("nan"))


def _compare_mask(
    rel: Relation,
    lhs: str,
    op: str,
    kind: str,
    ref,
    consts_i: torch.Tensor,
    consts_f: torch.Tensor,
    num_vals: torch.Tensor,
) -> torch.Tensor:
    """One comparison as a boolean mask (validity handled by the caller).

      kind "var" — rhs is the variable named `ref`;
      kind "id"  — rhs is the term id `consts_i[ref]` (= / != by identity);
      kind "num" — rhs is the float `consts_f[ref]` (compared by value via
                   the dictionary's numeric table).
    SPARQL error semantics: an unbound operand, or a non-numeric term under
    a numeric comparison, fails the comparison — even for `!=`. With only
    `&&`/`||` above (no negation), error-as-false composes exactly like
    three-valued logic would.
    """
    a = rel.column(lhs)
    if kind == "num" or (kind == "var" and op in ("<", "<=", ">", ">=")):
        va = _numeric_of(a, num_vals)
        vb = (
            _numeric_of(rel.column(ref), num_vals)
            if kind == "var"
            else consts_f[ref]
        )
        ok = ~torch.isnan(va) & ~torch.isnan(vb)
        return ok & _NUMERIC_CMP[op](va, vb)
    # term-identity comparison (= / != on ids)
    b = rel.column(ref) if kind == "var" else consts_i[ref]
    bound = a != int(UNBOUND)
    if kind == "var":
        bound = bound & (b != int(UNBOUND))
    eq = a == b
    return bound & (eq if op == "=" else ~eq)


def expr_mask(
    rel: Relation,
    expr: tuple,
    consts_i: torch.Tensor,
    consts_f: torch.Tensor,
    num_vals: torch.Tensor,
) -> torch.Tensor:
    """A plan_ir.FilterExpr as a composed device mask: comparisons at the
    leaves, `&`/`|` over ("and", ...) / ("or", ...) nodes."""
    tag = expr[0]
    if tag == "cmp":
        _, lhs, op, kind, ref = expr
        return _compare_mask(
            rel, lhs, op, kind, ref, consts_i, consts_f, num_vals
        )
    masks = [
        expr_mask(rel, c, consts_i, consts_f, num_vals) for c in expr[1]
    ]
    out = masks[0]
    for m in masks[1:]:
        out = (out & m) if tag == "and" else (out | m)
    return out


def filter_mask(
    rel: Relation,
    conds: tuple,
    consts_i: torch.Tensor,
    consts_f: torch.Tensor,
    num_vals: torch.Tensor,
) -> torch.Tensor:
    """Conjunction of filter expressions as a validity mask."""
    keep = rel.valid
    for expr in conds:
        keep = keep & expr_mask(rel, expr, consts_i, consts_f, num_vals)
    return keep


def union_all(rels: list[Relation], schema: tuple[str, ...]) -> Relation:
    """SPARQL UNION: multiset concatenation over an aligned schema.

    Columns a branch does not bind are filled with the UNBOUND sentinel
    (the decoder omits them; FILTER masks treat them as errors). Output
    capacity is the exact sum of branch capacities — never overflows.
    Duplicate solutions are preserved (multiset semantics); SELECT
    DISTINCT on top reuses the device `distinct` machinery to dedup.
    """
    cols_parts = []
    valid_parts = []
    for rel in rels:
        cols = [
            rel.column(v)
            if v in rel.schema
            else torch.full(
                (rel.capacity,), int(UNBOUND), dtype=_I32, device=rel.device
            )
            for v in schema
        ]
        cols_parts.append(torch.stack(cols, dim=1))
        valid_parts.append(rel.valid)
    return Relation(
        tuple(schema),
        torch.cat(cols_parts, dim=0),
        torch.cat(valid_parts, dim=0),
    )


def slice_valid(rel: Relation, offset, limit) -> Relation:
    """LIMIT/OFFSET over the valid rows, in buffer order.

    `offset`/`limit` may be 0-d device tensors, so one compiled program
    serves every (offset, limit) combination of the same plan shape.
    """
    rank = torch.cumsum(rel.valid, dim=0, dtype=_I32)
    keep = rel.valid & (rank > offset) & (rank <= offset + limit)
    return Relation(rel.schema, rel.cols, keep)
