"""Public pair-expand op: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor.

On the card the op is a `torch.library` custom op with a vmap rule, so
`torch.func.vmap` over a stacked plan program (core/executor.lower_batched)
maps a batched call onto ONE launch of the kernel's stacked form, whatever
the number of lanes. The plain version is plain torch and batches under
vmap by torch's own rules. A meta tensor takes the op's shape rule (the
dry-run traces a step on meta tensors), never the plain version."""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.obs.costs import kernel_call
from repro_torch.kernels.pair_expand import kernel as _k
from repro_torch.kernels.pair_expand import ref as _ref


def pair_expand(prefix: torch.Tensor, counts: torch.Tensor, capacity: int):
    """For each output slot: (sorted-left row, offset within group, valid)."""
    fn = _ref.pair_expand if prefix.device.type == "cpu" else _pair_expand_cuda
    return kernel_call("pair_expand", fn, prefix, counts, capacity)


@torch.library.custom_op(
    "repro_torch::pair_expand", mutates_args=(), device_types="cuda"
)
def _pair_expand_cuda(
    prefix: torch.Tensor, counts: torch.Tensor, capacity: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _k.pair_expand_cuda(
        prefix.contiguous(), counts.contiguous(), capacity
    )


@_pair_expand_cuda.register_fake
def _pair_expand_fake(prefix, counts, capacity):
    shape = (*prefix.shape[:-1], capacity)
    return (prefix.new_empty(shape), prefix.new_empty(shape),
            prefix.new_empty(shape, dtype=torch.bool))


@_pair_expand_cuda.register_vmap
def _pair_expand_vmap(info, in_dims, prefix, counts, capacity):
    prefix, counts = (
        kernels.lanes_first(x, d, info.batch_size).contiguous()
        for x, d in zip((prefix, counts), in_dims)
    )
    if prefix.device.type == "meta":
        return _pair_expand_fake(prefix, counts, capacity), (0, 0, 0)
    return _k.pair_expand_cuda(prefix, counts, capacity), (0, 0, 0)
