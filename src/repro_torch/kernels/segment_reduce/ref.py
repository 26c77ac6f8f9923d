"""Plain PyTorch version of the sorted segment sum: dropped ids masked, the
sum taken in float32, the result cast back to the data's type."""
from __future__ import annotations

import torch


def sorted_segment_sum(data: torch.Tensor, ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    n, d = data.shape
    keep = (ids >= 0) & (ids < num_segments)
    # dropped rows land in a spare segment that is sliced off
    slot = torch.where(keep, ids, num_segments).long()
    acc = torch.zeros(
        (num_segments + 1, d), dtype=torch.float32, device=data.device
    ).scatter_add(0, slot[:, None].expand(n, d), data.float())
    return acc[:num_segments].to(data.dtype)
