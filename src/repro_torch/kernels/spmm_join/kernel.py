"""ctypes bindings of the CUDA layout kernels (csrc/match_layout.cu and
csrc/sort_ranks.cu). Each takes (n,) inputs or a stack of lanes (lanes, n)
and launches once either way."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels

PACKAGE = "spmm_join"
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache  # one lookup and argtypes setup per launcher
def _launcher(stem: str, argtypes: tuple):
    fn = getattr(kernels.load(PACKAGE, stem), f"{stem}_launch")
    fn.argtypes = list(argtypes)
    fn.restype = _I
    return fn


def _check_keys(x: torch.Tensor, what: str) -> tuple[int, int]:
    kernels.check_int32(x, what)
    lanes, n = kernels.lanes_of(x)
    if not 1 <= n < 2**31:
        raise ValueError(f"{what}: length {n} out of range")
    return lanes, n


def match_layout_cuda(left_keys: torch.Tensor, right_keys: torch.Tensor):
    """(counts, first, b) per left row and cl per right row, on the card."""
    lanes, n_l = _check_keys(left_keys, "left_keys")
    r_lanes, n_r = _check_keys(right_keys, "right_keys")
    if (left_keys.dim() != right_keys.dim() or lanes != r_lanes
            or left_keys.device != right_keys.device):
        raise ValueError("left and right keys must stack the same lanes "
                         "on one device")
    dev = left_keys.device
    counts, first, b = (
        torch.empty(left_keys.shape, dtype=torch.int32, device=dev)
        for _ in range(3)
    )
    cl = torch.empty(right_keys.shape, dtype=torch.int32, device=dev)
    if lanes == 0:
        return counts, first, b, cl
    fn = _launcher("match_layout", (_P, _P, _I, _I, _I, _P, _P, _P, _P, _P))
    with torch.cuda.device(dev):
        err = fn(
            left_keys.data_ptr(), right_keys.data_ptr(), lanes, n_l, n_r,
            counts.data_ptr(), first.data_ptr(), b.data_ptr(), cl.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check_launch("match_layout", err)
    kernels.LAUNCHES["match_layout"] += 1
    return counts, first, b, cl


def sort_ranks_cuda(keys: torch.Tensor) -> torch.Tensor:
    """Each key's stable sorted position, on the card."""
    lanes, n = _check_keys(keys, "keys")
    dev = keys.device
    rank = torch.empty(keys.shape, dtype=torch.int32, device=dev)
    if lanes == 0:
        return rank
    fn = _launcher("sort_ranks", (_P, _I, _I, _P, _P))
    with torch.cuda.device(dev):
        err = fn(
            keys.data_ptr(), lanes, n, rank.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check_launch("sort_ranks", err)
    kernels.LAUNCHES["sort_ranks"] += 1
    return rank
