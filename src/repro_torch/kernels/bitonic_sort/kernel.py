"""ctypes binding of the CUDA pair sort (csrc/bitonic_sort.cu): a bitonic
network in one block up to one tile, a stable LSD radix sort above."""
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
    fn.argtypes = [_P, _P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P, _P]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _scratch_ints():
    fn = kernels.load(NAME, NAME).bitonic_sort_scratch_ints
    fn.argtypes = [ctypes.c_longlong]
    fn.restype = ctypes.c_longlong
    return fn


def stable_at(n: int) -> bool:
    """Whether the launcher sorts n pairs on its stable radix path (n above
    one block's tile, the path that needs scratch)."""
    return _scratch_ints()(n) > 0


def sort_pairs_cuda(keys: torch.Tensor, vals: torch.Tensor):
    """(keys, payloads) sorted by key ascending, on the card; any length up
    to 2^30, in one call of the launcher (its launches run in order on the
    current stream). Stable where `stable_at(n)`."""
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
    scratch_ints = _scratch_ints()(n)
    if scratch_ints:  # the radix path ping-pongs through a second pair
        tmp_k, tmp_v = torch.empty_like(keys), torch.empty_like(vals)
        scratch = torch.empty(scratch_ints, dtype=torch.int32, device=dev)
        tmp = (tmp_k.data_ptr(), tmp_v.data_ptr(), scratch.data_ptr())
    else:
        tmp = (None, None, None)
    device_launches = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = _launcher()(
            keys.data_ptr(), vals.data_ptr(), n, out_k.data_ptr(),
            out_v.data_ptr(), *tmp, ctypes.addressof(device_launches),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check_launch(NAME, err)
    kernels.LAUNCHES[NAME] += 1
    kernels.DEVICE_LAUNCHES[NAME] += device_launches.value
    return out_k, out_v
