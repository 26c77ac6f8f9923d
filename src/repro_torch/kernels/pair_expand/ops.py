"""Public pair-expand op: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor."""
from __future__ import annotations

import torch

from repro_torch.kernels.pair_expand import kernel as _k
from repro_torch.kernels.pair_expand import ref as _ref


def pair_expand(prefix: torch.Tensor, counts: torch.Tensor, capacity: int):
    """For each output slot: (sorted-left row, offset within group, valid)."""
    if prefix.device.type == "cpu":
        return _ref.pair_expand(prefix, counts, capacity)
    return _k.pair_expand_cuda(
        prefix.contiguous(), counts.contiguous(), capacity
    )
