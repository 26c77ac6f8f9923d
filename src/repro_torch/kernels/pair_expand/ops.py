"""Public pair-expand op: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor.

On the card the op is a `torch.library` custom op with a vmap rule, so
`torch.func.vmap` over a stacked plan program (core/executor.lower_batched)
maps a batched call onto ONE launch of the kernel's stacked form, whatever
the number of lanes. The plain version is plain torch and batches under
vmap by torch's own rules."""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels.pair_expand import kernel as _k
from repro_torch.kernels.pair_expand import ref as _ref


def pair_expand(prefix: torch.Tensor, counts: torch.Tensor, capacity: int):
    """For each output slot: (sorted-left row, offset within group, valid)."""
    if prefix.device.type == "cpu":
        return _ref.pair_expand(prefix, counts, capacity)
    return _pair_expand_cuda(prefix, counts, capacity)


@torch.library.custom_op(
    "repro_torch::pair_expand", mutates_args=(), device_types="cuda"
)
def _pair_expand_cuda(
    prefix: torch.Tensor, counts: torch.Tensor, capacity: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _k.pair_expand_cuda(
        prefix.contiguous(), counts.contiguous(), capacity
    )


@_pair_expand_cuda.register_vmap
def _pair_expand_vmap(info, in_dims, prefix, counts, capacity):
    prefix, counts = (
        kernels.lanes_first(x, d, info.batch_size).contiguous()
        for x, d in zip((prefix, counts), in_dims)
    )
    return _k.pair_expand_cuda(prefix, counts, capacity), (0, 0, 0)
