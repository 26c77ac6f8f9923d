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
    fn.argtypes = [_P, _P, _I, _I, _I, _P, _P, _P, _P]
    fn.restype = _I
    return fn


@functools.cache
def _search_path():
    fn = kernels.load(NAME, NAME).pair_expand_search_path
    fn.argtypes = [_I, _I]
    fn.restype = _I
    return fn


def search_at(lanes: int, capacity: int) -> bool:
    """Whether the launcher expands `lanes` rows of `capacity` slots on its
    search path (a thread per slot) rather than its merge path."""
    return bool(_search_path()(lanes, capacity))


def pair_expand_cuda(prefix: torch.Tensor, counts: torch.Tensor, capacity: int):
    """(row, offset-in-group, valid) per output slot, on the card.

    `prefix` and `counts` are (n_left,) or stacked (lanes, n_left); the
    outputs are (capacity,) or (lanes, capacity) to match, in one launch
    (the search path up to 2^18 slots in all, the merge path above)."""
    kernels.check_int32(prefix, "prefix")
    kernels.check_int32(counts, "counts")
    if counts.shape != prefix.shape or counts.device != prefix.device:
        raise ValueError("prefix and counts must match in shape and device")
    lanes, n_left = kernels.lanes_of(prefix)
    if n_left < 1 or capacity < 0 or capacity >= 2**31:
        raise ValueError(f"bad sizes: n_left={n_left} capacity={capacity}")
    dev = prefix.device
    shape = (*prefix.shape[:-1], capacity)
    out_i = torch.empty(shape, dtype=torch.int32, device=dev)
    out_off = torch.empty(shape, dtype=torch.int32, device=dev)
    out_valid = torch.empty(shape, dtype=torch.bool, device=dev)
    if capacity == 0 or lanes == 0:
        return out_i, out_off, out_valid
    fn = _launcher()
    with torch.cuda.device(dev):
        err = fn(
            prefix.data_ptr(), counts.data_ptr(), lanes, n_left, capacity,
            out_i.data_ptr(), out_off.data_ptr(), out_valid.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check_launch(NAME, err)
    kernels.LAUNCHES[NAME] += 1
    return out_i, out_off, out_valid
