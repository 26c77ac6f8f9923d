"""Public layout ops of the matrix join: the CUDA kernels for CUDA tensors,
the plain versions for CPU tensors.

The kernels mask their ragged edges themselves, so no padding to a block
multiple is needed and every size takes the kernel on the card. On the card
each op is a `torch.library` custom op with a vmap rule that maps a batched
call onto ONE launch of the kernel's stacked form (see
kernels/pair_expand/ops.py); the plain versions batch under vmap by
torch's own rules.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels.spmm_join import kernel as _k
from repro_torch.kernels.spmm_join import ref as _ref


def match_layout(left_keys: torch.Tensor, right_keys: torch.Tensor):
    """(counts[i], first[i], b[i], cl[j]): the full output layout of the
    join, from one dense eq/lt pass (see ref.match_layout)."""
    if left_keys.device.type == "cpu":
        return _ref.match_layout(left_keys, right_keys)
    return _match_layout_cuda(left_keys, right_keys)


def sort_ranks(keys: torch.Tensor) -> torch.Tensor:
    """rank[j] = the row's stable sorted position (a permutation of 0..n-1)."""
    if keys.device.type == "cpu":
        return _ref.sort_ranks(keys)
    return _sort_ranks_cuda(keys)


@torch.library.custom_op(
    "repro_torch::match_layout", mutates_args=(), device_types="cuda"
)
def _match_layout_cuda(
    left_keys: torch.Tensor, right_keys: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    return _k.match_layout_cuda(left_keys.contiguous(), right_keys.contiguous())


@_match_layout_cuda.register_vmap
def _match_layout_vmap(info, in_dims, left_keys, right_keys):
    lk, rk = (
        kernels.lanes_first(x, d, info.batch_size).contiguous()
        for x, d in zip((left_keys, right_keys), in_dims)
    )
    return _k.match_layout_cuda(lk, rk), (0, 0, 0, 0)


@torch.library.custom_op(
    "repro_torch::sort_ranks", mutates_args=(), device_types="cuda"
)
def _sort_ranks_cuda(keys: torch.Tensor) -> torch.Tensor:
    return _k.sort_ranks_cuda(keys.contiguous())


@_sort_ranks_cuda.register_vmap
def _sort_ranks_vmap(info, in_dims, keys):
    keys = kernels.lanes_first(keys, in_dims[0], info.batch_size)
    return _k.sort_ranks_cuda(keys.contiguous()), 0
