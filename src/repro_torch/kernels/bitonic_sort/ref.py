"""Plain PyTorch version of the pair sort: a sort of the keys and a gather
of the payloads."""
from __future__ import annotations

import torch


def sort_pairs(keys: torch.Tensor, vals: torch.Tensor):
    sk, order = torch.sort(keys, stable=True)
    return sk, vals[order]


def argsort_i32(keys: torch.Tensor) -> torch.Tensor:
    return torch.sort(keys, stable=True).indices.to(torch.int32)
