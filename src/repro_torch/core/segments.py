"""Segment helpers shared by the joins, GNN aggregation and the embedding
bag: everything downstream of "sort by key" reasons in contiguous segments.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import kernels
from repro_torch.kernels.segment_reduce import ops as seg_ops


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """numpy.lexsort for 1-D tensors: the LAST key is the primary one.

    torch has no lexsort; chained stable sorts, least-significant key
    first, give the same permutation (each later sort keeps the order of
    the earlier ones among its ties). Returns int64 indices."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def dense_rank_two_sided(left_keys: torch.Tensor, right_keys: torch.Tensor):
    """Dense-rank multi-column keys jointly across two relations.

    Returns int32 ranks (l_rank, r_rank) such that rows from either side have
    equal rank iff their key tuples are equal, and ranks are ordered
    lexicographically. This reduces multi-variable SPARQL joins to a
    single-int32-key join without 64-bit packing.

    left_keys: (n_l, k) int32, right_keys: (n_r, k) int32.
    """
    n_l = left_keys.shape[0]
    all_keys = torch.cat([left_keys, right_keys], dim=0)
    # primary key is column 0 -> pass columns reversed
    order = lexsort([all_keys[:, c] for c in reversed(range(all_keys.shape[1]))])
    sorted_keys = all_keys[order]
    new_group = (sorted_keys != torch.roll(sorted_keys, 1, dims=0)).any(dim=1)
    new_group = new_group | first_row(new_group)
    rank_sorted = cumsum_i32(new_group) - 1
    ranks = torch.empty_like(rank_sorted).scatter(0, order, rank_sorted)
    return ranks[:n_l], ranks[n_l:]


def first_row(x: torch.Tensor) -> torch.Tensor:
    """A bool mask of x's rows that is True at row 0 only.

    The joins write no element in place (no item assignment, which copies
    to the host, and no in-place op, which torch.func.vmap cannot batch
    into a fresh unbatched buffer): they combine with this mask instead."""
    return torch.arange(x.shape[0], device=x.device) == 0


def segment_offsets_from_sorted(sorted_ids: torch.Tensor, num_segments: int):
    """Start offsets of each segment id in a sorted id array.

    offsets has length num_segments + 1; segment s occupies
    [offsets[s], offsets[s+1]).
    """
    probes = torch.arange(
        num_segments + 1, dtype=sorted_ids.dtype, device=sorted_ids.device
    )
    return torch.searchsorted(sorted_ids, probes, out_int32=True)


def counts_to_segment_ids(counts: torch.Tensor, total: int):
    """Inverse of bincount for sorted data: e.g. [2,0,3] -> [0,0,2,2,2].

    `total` is the static output length; positions beyond sum(counts) get id
    = len(counts) (one past the last segment) so callers can mask them.
    """
    counts = counts.to(torch.int32)
    starts = cumsum_i32(counts) - counts
    # scatter-add 1 at each segment start; starts past the end land in a
    # spare slot that is sliced off (the reference drops them)
    out = torch.zeros(total + 1, dtype=torch.int32, device=counts.device)
    out = out.scatter_add(
        0, starts.clamp(max=total).long(), (counts > 0).to(torch.int32)
    )
    ids = cumsum_i32(out[:total]) - 1
    t = torch.arange(total, dtype=torch.int32, device=counts.device)
    beyond = torch.full_like(ids, len(counts))
    return torch.where(t < counts.sum(dtype=torch.int32), ids, beyond)


def _rows_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sums along the last axis. A stack of rows is
    summed as ONE flat scan minus each row's start: torch's scan of a 2-D
    tensor along its last axis runs one block a row, which on the card
    takes milliseconds for a few long rows. Both steps wrap modulo 2^32,
    so each row equals its own int32 running sum, and the subtraction is
    made in place: no buffer beyond the output."""
    if x.dim() == 1:
        return torch.cumsum(x, dim=0, dtype=torch.int32)
    n = x.shape[-1]
    if x.numel() == 0:
        return torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    flat = torch.cumsum(x.reshape(-1), dim=0, dtype=torch.int32).view(-1, n)
    ends = flat[:, -1]
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    return flat.sub_(starts[:, None]).view(x.shape)


@torch.library.custom_op("repro_torch::cumsum_i32", mutates_args=())
def cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of an int or bool tensor along its last axis,
    as int32. Under torch.func.vmap its rule sums every lane's row in one
    flat scan (see _rows_cumsum) instead of torch's per-row scan."""
    return _rows_cumsum(x)


@cumsum_i32.register_fake
def _cumsum_i32_fake(x):
    return x.new_empty(x.shape, dtype=torch.int32)


@cumsum_i32.register_vmap
def _cumsum_i32_vmap(info, in_dims, x):
    return _rows_cumsum(kernels.lanes_first(x, in_dims[0], info.batch_size)), 0


def sorted_segment_sum(data: torch.Tensor, sorted_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """segment_sum specialised to sorted ids (the post-shuffle MapSQ
    reduce): `kernels.segment_reduce` on a CUDA tensor (float32 or
    bfloat16, int32 ids), its plain version on a CPU tensor. Trailing dims
    are summed as one row of their product (1-D data as (n, 1)); ids
    outside [0, num_segments) are dropped."""
    out = seg_ops.sorted_segment_sum(data.reshape(data.shape[0], -1), sorted_ids,
                                 num_segments)
    return out.reshape(num_segments, *data.shape[1:])


def _drop_slot(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """int64 scatter slots: ids outside [0, num_segments) go to a spare slot
    num_segments, which the caller slices off (jax.ops drops them)."""
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    return torch.where(keep, segment_ids, num_segments).long()


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """jax.ops.segment_sum for ids in any order: a plain scatter-add (the
    kernel assumes sorted ids), ids outside [0, num_segments) dropped."""
    flat = data.reshape(data.shape[0], -1)
    out = flat.new_zeros((num_segments + 1, flat.shape[1])).index_add_(
        0, _drop_slot(segment_ids, num_segments), flat)
    return out[:num_segments].reshape(num_segments, *data.shape[1:])


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """jax.ops.segment_max (plain; no kernel): an empty segment is -inf,
    ids outside [0, num_segments) are dropped."""
    flat = data.reshape(data.shape[0], -1)
    slot = _drop_slot(segment_ids, num_segments)[:, None].expand(flat.shape)
    out = flat.new_full((num_segments + 1, flat.shape[1]), float("-inf"))
    out = out.scatter_reduce(0, slot, flat, reduce="amax")
    return out[:num_segments].reshape(num_segments, *data.shape[1:])


def _take_clamped(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """x[ids] as jnp indexing gathers: negative ids count from the end,
    then every id is clamped into range."""
    n = x.shape[0]
    return x[torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)]


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Numerically-stable softmax within segments (GAT edge softmax), over
    dim 0 of scores (each trailing column on its own)."""
    seg_max = segment_max(scores, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    shifted = scores - _take_clamped(seg_max, segment_ids)
    expd = torch.exp(shifted)
    seg_sum = segment_sum(expd, segment_ids, num_segments)
    return expd / _take_clamped(seg_sum, segment_ids).clamp_min(1e-30)
