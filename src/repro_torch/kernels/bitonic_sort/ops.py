"""Public pair-sort API: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors. Every length takes the kernel on the card; there
is no route to another sort by size."""
from __future__ import annotations

import torch

from repro_torch.kernels.bitonic_sort import kernel as _k
from repro_torch.kernels.bitonic_sort import ref as _ref


def sort_pairs(keys: torch.Tensor, vals: torch.Tensor):
    """Sort int32 (keys, vals) by key ascending; any length.

    NOTE: the bitonic network is not stable — equal keys may permute their
    payloads on the card (the plain version happens to be stable; callers
    must not rely on either order among equal keys)."""
    if keys.device.type == "cpu":
        return _ref.sort_pairs(keys, vals)
    return _k.sort_pairs_cuda(keys.contiguous(), vals.contiguous())


def argsort_i32(keys: torch.Tensor) -> torch.Tensor:
    """Permutation sorting `keys` ascending (payload = row index)."""
    n = keys.shape[0]
    _, order = sort_pairs(
        keys, torch.arange(n, dtype=torch.int32, device=keys.device)
    )
    return order
