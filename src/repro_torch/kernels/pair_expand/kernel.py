"""ctypes binding of the CUDA pair-expand kernel (csrc/pair_expand.cu)."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels

NAME = "pair_expand"
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache  # one lookup and argtypes setup per launcher
def _launcher():
    lib = kernels.load(NAME, NAME)
    fn = lib.pair_expand_launch
    fn.argtypes = [_P, _P, _I, _I, _P, _P, _P, _P]
    fn.restype = _I
    return fn


def _check(x: torch.Tensor, what: str) -> None:
    if not x.is_cuda or x.dtype != torch.int32 or x.dim() != 1:
        raise ValueError(
            f"{what}: expected a 1-D int32 CUDA tensor, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def pair_expand_cuda(prefix: torch.Tensor, counts: torch.Tensor, capacity: int):
    """(row, offset-in-group, valid) per output slot, on the card."""
    _check(prefix, "prefix")
    _check(counts, "counts")
    n_left = prefix.shape[0]
    if counts.shape[0] != n_left or counts.device != prefix.device:
        raise ValueError("prefix and counts must match in length and device")
    if n_left < 1 or capacity < 0 or capacity >= 2**31:
        raise ValueError(f"bad sizes: n_left={n_left} capacity={capacity}")
    dev = prefix.device
    out_i = torch.empty(capacity, dtype=torch.int32, device=dev)
    out_off = torch.empty(capacity, dtype=torch.int32, device=dev)
    out_valid = torch.empty(capacity, dtype=torch.bool, device=dev)
    if capacity == 0:
        return out_i, out_off, out_valid
    fn = _launcher()
    with torch.cuda.device(dev):
        err = fn(
            prefix.data_ptr(), counts.data_ptr(), n_left, capacity,
            out_i.data_ptr(), out_off.data_ptr(), out_valid.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check_launch(NAME, err)
    kernels.LAUNCHES[NAME] += 1
    return out_i, out_off, out_valid
