"""ctypes binding of the CUDA bitonic sort (csrc/bitonic_sort.cu)."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels

NAME = "bitonic_sort"
MAX_N = 2**30
_P = ctypes.c_void_p


@functools.cache  # one lookup and argtypes setup per launcher
def _launcher():
    fn = kernels.load(NAME, NAME).bitonic_sort_launch
    fn.argtypes = [_P, _P, ctypes.c_longlong, _P, _P, _P]
    fn.restype = ctypes.c_int
    return fn


def sort_pairs_cuda(keys: torch.Tensor, vals: torch.Tensor):
    """(keys, payloads) sorted by key ascending, on the card; any length up
    to 2^30, in one call of the launcher (its steps run in order on the
    current stream)."""
    kernels.check_int32(keys, "keys")
    kernels.check_int32(vals, "vals")
    if keys.dim() != 1 or vals.shape != keys.shape or vals.device != keys.device:
        raise ValueError("keys and vals must be 1-D, of one length and device")
    n = keys.shape[0]
    if n > MAX_N:
        raise ValueError(f"length {n} exceeds {MAX_N}")
    out_k = torch.empty_like(keys)
    out_v = torch.empty_like(vals)
    if n == 0:
        return out_k, out_v
    dev = keys.device
    with torch.cuda.device(dev):
        err = _launcher()(
            keys.data_ptr(), vals.data_ptr(), n, out_k.data_ptr(),
            out_v.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check_launch(NAME, err)
    kernels.LAUNCHES[NAME] += 1
    return out_k, out_v
