"""Plain PyTorch version of pair expansion (the expand half of Algorithm 1)."""
from __future__ import annotations

import torch


def pair_expand(prefix: torch.Tensor, counts: torch.Tensor, capacity: int):
    n_left = prefix.shape[0]
    t = torch.arange(capacity, dtype=torch.int32, device=prefix.device)
    i = torch.searchsorted(prefix, t, right=True, out_int32=True)
    i = i.clamp(0, n_left - 1)
    start = prefix[i] - counts[i]
    total = prefix[-1]
    return i, t - start, t < total
