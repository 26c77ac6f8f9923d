"""The matrix join backend: MapSQ's equi-join as masked SpMM reductions.

Where Algorithm 1 (core/mr_join.py) realises the join as Map -> Sort ->
ReduceDuplicate, this backend — the gSMat/gSmart reformulation — never
sorts. The Map phase is shared (sentinel-tagged key extraction); then
dense masked reductions (kernels/spmm_join) drive the whole join:

  counts[i], first[i], b[i], cl[j]  <- match_layout: one eq/lt compare pass
  pos[j]    = stable sorted rank of rk[j]  (less-than + earlier-equal sum,
              right side only — the small input)

Left row i's outputs start at slot  start[i] = Pex[first[i]] + b[i],
where Pex is the exclusive prefix of cl in sorted-right order: slots for
all smaller keys, plus slots claimed by earlier same-key left rows. The
expansion scatters the slot-monotone code first[i]*n_l + i at start[i] and
running-maxes it across slots to recover each slot's left row; the right
row is then a gather into the sorted-right inverse permutation at first +
occurrence rank.

Match ordering is IDENTICAL to mr_join's (left rows in stable key order,
then right buffer order within a key), so the two backends are
bit-compatible, not just set-equal.
"""
from __future__ import annotations

import torch

from repro_torch.core.mr_join import _expanded_cols, _map_phase
from repro_torch.core.relation import UNBOUND, Relation, shared_vars
from repro_torch.core.segments import cumsum_i32
from repro_torch.kernels.spmm_join import ops as spmm_ops

_I32 = torch.int32


def _match_arrays(left: Relation, right: Relation):
    key_vars = shared_vars(left, right)
    if not key_vars:
        raise ValueError(
            f"cross join between {left.schema} and {right.schema}; "
            "use cross_join()"
        )
    l_key, r_key = _map_phase(left, right, key_vars)
    counts, first, b, cl = spmm_ops.match_layout(l_key, r_key)
    pos_r = spmm_ops.sort_ranks(r_key)
    return counts, first, b, cl, pos_r


def _expand_gather(counts, first, b, cl, pos_r, capacity: int):
    """Gather each output slot's (left row, right row) pair.

    start[i] = Pex[first[i]] + b[i] places each matching row's slot range
    directly, and the slot-monotone code first[i]*n_l + i — strictly
    increasing along the emission order, decodable with one mod — is
    scattered at range starts and cummax-filled to invert the mapping.
    Zero-count rows and starts past the capacity land in a spare slot that
    is sliced off (the reference drops them). The code is int64: first[i] *
    n_l reaches 2^31 once n_l * n_r does, and a wrapped code is not
    monotone (the reference keeps it int32, so its rows leave mr_join's
    order there).
    """
    n_l, n_r = counts.shape[0], pos_r.shape[0]
    dev = counts.device
    rows = torch.arange(n_l, dtype=_I32, device=dev)
    # right side in stable key order: j_at[pos_r[j]] = j (no argsort)
    j_at = torch.empty(n_r, dtype=_I32, device=dev).scatter(
        0, pos_r.long(), torch.arange(n_r, dtype=_I32, device=dev)
    )
    if n_r:
        cl_sorted = cl[j_at]
        pex = cumsum_i32(cl_sorted) - cl_sorted
        before_key = pex[first.clamp(0, n_r - 1)]
    else:
        before_key = torch.zeros_like(first)
    start = before_key + b
    total = counts.sum(dtype=_I32)
    idx = torch.where(counts > 0, start, capacity).clamp(0, capacity)
    marks = torch.zeros(capacity + 1, dtype=torch.int64, device=dev).scatter(
        0, idx.long(), first.long() * n_l + rows
    )
    li = (torch.cummax(marks[:capacity], dim=0).values % max(n_l, 1)).to(_I32)
    k = torch.arange(capacity, dtype=_I32, device=dev)
    r_k = k - start[li]  # occurrence rank of slot k within its left row
    rj = j_at[(first[li] + r_k).clamp(0, max(n_r - 1, 0))]
    valid = k < total
    return li, rj, valid, total


def matrix_join(
    left: Relation,
    right: Relation,
    capacity: int,
) -> tuple[Relation, torch.Tensor, torch.Tensor]:
    """Matrix-backend equi-join; same contract and output schema as
    mr_join: (result, exact_total, overflowed), schema = left vars then
    right vars not already bound, rows past capacity truncated exactly."""
    counts, first, b, cl, pos_r = _match_arrays(left, right)
    li, rj, valid, total = _expand_gather(counts, first, b, cl, pos_r, capacity)
    out_schema, _, cols = _expanded_cols(left, right, li, rj, valid, capacity)
    return Relation(out_schema, cols, valid), total, total > capacity


def matrix_left_join(
    left: Relation,
    right: Relation,
    capacity: int,
) -> tuple[Relation, torch.Tensor, torch.Tensor]:
    """OPTIONAL on the matrix backend; same layout as mr_join.left_join:
    `capacity` inner-join slots, then left.capacity unmatched-left padding
    slots with right-only columns UNBOUND. The unmatched mask falls out of
    the counts vector directly (counts are already in left buffer order)."""
    counts, first, b, cl, pos_r = _match_arrays(left, right)
    li, rj, valid, total = _expand_gather(counts, first, b, cl, pos_r, capacity)
    out_schema, right_extra, join_cols = _expanded_cols(
        left, right, li, rj, valid, capacity
    )
    unmatched = left.valid & (counts == 0)
    pad = torch.full(
        (left.capacity, len(right_extra)), int(UNBOUND), dtype=_I32,
        device=left.device,
    )
    cols = torch.cat([join_cols, torch.cat([left.cols, pad], dim=1)], dim=0)
    valid_all = torch.cat([valid, unmatched])
    return Relation(out_schema, cols, valid_all), total, total > capacity
