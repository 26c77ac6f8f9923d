"""Public pair-sort API: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors. Every length takes the kernel on the card (its
launcher picks the one-block network or the radix passes by length); there
is no route to another sort. A meta tensor gets the outputs' shapes and
dtypes; it never runs the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels.bitonic_sort import kernel as _k
from repro_torch.kernels.bitonic_sort import ref as _ref
from repro_torch.obs.costs import kernel_call


def sort_pairs(keys: torch.Tensor, vals: torch.Tensor):
    """Sort int32 (keys, vals) by key ascending; any length.

    NOTE: not stable — on the card, up to one tile (8192 pairs) a bitonic
    network sorts in one block and equal keys may permute their payloads;
    above it a radix sort keeps their order, as the plain version does.
    Callers must not rely on any order among equal keys."""
    return kernel_call("bitonic_sort", _sort_pairs, keys, vals)


def _sort_pairs(keys: torch.Tensor, vals: torch.Tensor):
    if keys.device.type == "cpu":
        return _ref.sort_pairs(keys, vals)
    if keys.device.type == "meta":  # the shapes alone
        return keys.new_empty(keys.shape), vals.new_empty(vals.shape)
    return _k.sort_pairs_cuda(keys.contiguous(), vals.contiguous())


def argsort_i32(keys: torch.Tensor) -> torch.Tensor:
    """Permutation sorting `keys` ascending (payload = row index)."""
    n = keys.shape[0]
    _, order = sort_pairs(
        keys, torch.arange(n, dtype=torch.int32, device=keys.device)
    )
    return order
