"""ctypes bindings of the CUDA layout kernels (csrc/match_layout.cu and
csrc/sort_ranks.cu)."""
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


def _check_keys(x: torch.Tensor, what: str) -> None:
    if not x.is_cuda or x.dtype != torch.int32 or x.dim() != 1:
        raise ValueError(
            f"{what}: expected a 1-D int32 CUDA tensor, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if not 1 <= x.shape[0] < 2**31:
        raise ValueError(f"{what}: length {x.shape[0]} out of range")


def match_layout_cuda(left_keys: torch.Tensor, right_keys: torch.Tensor):
    """(counts, first, b) per left row and cl per right row, on the card."""
    _check_keys(left_keys, "left_keys")
    _check_keys(right_keys, "right_keys")
    if left_keys.device != right_keys.device:
        raise ValueError("left and right keys must be on one device")
    dev = left_keys.device
    n_l, n_r = left_keys.shape[0], right_keys.shape[0]
    counts, first, b = (
        torch.empty(n_l, dtype=torch.int32, device=dev) for _ in range(3)
    )
    cl = torch.empty(n_r, dtype=torch.int32, device=dev)
    fn = _launcher("match_layout", (_P, _P, _I, _I, _P, _P, _P, _P, _P))
    with torch.cuda.device(dev):
        err = fn(
            left_keys.data_ptr(), right_keys.data_ptr(), n_l, n_r,
            counts.data_ptr(), first.data_ptr(), b.data_ptr(), cl.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check_launch("match_layout", err)
    kernels.LAUNCHES["match_layout"] += 1
    return counts, first, b, cl


def sort_ranks_cuda(keys: torch.Tensor) -> torch.Tensor:
    """Each key's stable sorted position, on the card."""
    _check_keys(keys, "keys")
    dev = keys.device
    rank = torch.empty(keys.shape[0], dtype=torch.int32, device=dev)
    fn = _launcher("sort_ranks", (_P, _I, _P, _P))
    with torch.cuda.device(dev):
        err = fn(
            keys.data_ptr(), keys.shape[0], rank.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check_launch("sort_ranks", err)
    kernels.LAUNCHES["sort_ranks"] += 1
    return rank
