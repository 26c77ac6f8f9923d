"""Public layout ops of the matrix join: the CUDA kernels for CUDA tensors,
the plain versions for CPU tensors.

The kernels mask their ragged edges themselves, so no padding to a block
multiple is needed and every size takes the kernel on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.spmm_join import kernel as _k
from repro_torch.kernels.spmm_join import ref as _ref


def match_layout(left_keys: torch.Tensor, right_keys: torch.Tensor):
    """(counts[i], first[i], b[i], cl[j]): the full output layout of the
    join, from one dense eq/lt pass (see ref.match_layout)."""
    if left_keys.device.type == "cpu":
        return _ref.match_layout(left_keys, right_keys)
    return _k.match_layout_cuda(left_keys.contiguous(), right_keys.contiguous())


def sort_ranks(keys: torch.Tensor) -> torch.Tensor:
    """rank[j] = the row's stable sorted position (a permutation of 0..n-1)."""
    if keys.device.type == "cpu":
        return _ref.sort_ranks(keys)
    return _k.sort_ranks_cuda(keys.contiguous())
