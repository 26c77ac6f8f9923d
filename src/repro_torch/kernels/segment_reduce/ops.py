"""Public sorted-segment-sum API: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors. Every number of segments takes the kernel
on the card; there is no route to the plain version by size.

Every device runs under one autograd rule: the forward is the kernel on
the card (the same bits and launch counts with or without a gradient)
and the plain version on the CPU, the backward a plain row gather,
`grad_out[ids]` with dropped ids at zero. The reference has no backward
kernel either: its GNN and DeepFM paths differentiate
`jax.ops.segment_sum`, whose gradient is that gather. A meta tensor gets
the output's shape and dtype under the same autograd rule (the dry-run
traces a step on meta tensors); it never runs the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels.segment_reduce import kernel as _k
from repro_torch.kernels.segment_reduce import ref as _ref
from repro_torch.obs.costs import kernel_call


class _SortedSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, ids, num_segments):
        ctx.save_for_backward(ids)
        ctx.num_segments = num_segments
        ctx.n_rows = data.shape[0]
        if data.device.type == "cpu":
            return _ref.sorted_segment_sum(data, ids, num_segments)
        if data.device.type == "meta":
            return data.new_empty((num_segments, data.shape[1]))
        return _k.sorted_segment_sum_cuda(data, ids, num_segments)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        s = ctx.num_segments
        if s == 0:
            return grad.new_zeros((ctx.n_rows, grad.shape[1])), None, None
        keep = (ids >= 0) & (ids < s)
        rows = grad[ids.clamp(0, s - 1).long()]
        return torch.where(keep[:, None], rows, 0), None, None


def sorted_segment_sum(data: torch.Tensor, ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Sum rows of `data` (n, d; float32 or bfloat16) by sorted segment id
    into (num_segments, d), accumulating in float32; ids outside
    [0, num_segments) are dropped."""
    return kernel_call("segment_reduce", _SortedSegmentSum.apply,
                       data.contiguous(), ids.contiguous(), num_segments)
