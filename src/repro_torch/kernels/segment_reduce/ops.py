"""Public sorted-segment-sum API: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors. Every number of segments takes the kernel
on the card; there is no route to the plain version by size."""
from __future__ import annotations

import torch

from repro_torch.kernels.segment_reduce import kernel as _k
from repro_torch.kernels.segment_reduce import ref as _ref


def sorted_segment_sum(data: torch.Tensor, ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Sum rows of `data` (n, d; float32 or bfloat16) by sorted segment id
    into (num_segments, d), accumulating in float32; ids outside
    [0, num_segments) are dropped."""
    if data.device.type == "cpu":
        return _ref.sorted_segment_sum(data, ids, num_segments)
    return _k.sorted_segment_sum_cuda(
        data.contiguous(), ids.contiguous(), num_segments
    )
