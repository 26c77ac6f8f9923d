"""Segment helpers the joins share: everything downstream of "sort by key"
reasons in contiguous segments.
"""
from __future__ import annotations

from typing import Sequence

import torch


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
    new_group[:1].fill_(True)  # fill_, not item assignment: no host copy
    rank_sorted = torch.cumsum(new_group, dim=0, dtype=torch.int32) - 1
    ranks = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    return ranks[:n_l], ranks[n_l:]


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
    starts = torch.cumsum(counts, dim=0, dtype=torch.int32) - counts
    # scatter-add 1 at each segment start; starts past the end land in a
    # spare slot that is sliced off (the reference drops them)
    out = torch.zeros(total + 1, dtype=torch.int32, device=counts.device)
    out.scatter_add_(
        0, starts.clamp(max=total).long(), (counts > 0).to(torch.int32)
    )
    ids = torch.cumsum(out[:total], dim=0, dtype=torch.int32) - 1
    t = torch.arange(total, dtype=torch.int32, device=counts.device)
    beyond = torch.full_like(ids, len(counts))
    return torch.where(t < counts.sum(dtype=torch.int32), ids, beyond)
