"""ctypes bindings of the CUDA layout kernels (csrc/match_layout.cu and
csrc/sort_ranks.cu). Each takes (n,) inputs or a stack of lanes (lanes, n)
and makes one launcher call either way: one device launch up to its
threshold, more above (match_layout: 25, sort_ranks: 12), the path picked
by the lengths alone."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels

PACKAGE = "spmm_join"
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache  # one lookup and argtypes setup per C function
def _c_function(stem: str, name: str, argtypes: tuple, restype=_I):
    fn = getattr(kernels.load(PACKAGE, stem), name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def _launcher(stem: str, argtypes: tuple):
    return _c_function(stem, f"{stem}_launch", argtypes)


def _scratch_ints(stem: str, *shape: int) -> int:
    """Ints of scratch a launcher needs for (lanes, lengths...), from its
    `*_scratch_ints` C function: 0 on its one-launch path."""
    return _c_function(stem, f"{stem}_scratch_ints", (_I,) * len(shape),
                       ctypes.c_longlong)(*shape)


def _scratch(stem: str, device, *shape: int):
    ints = _scratch_ints(stem, *shape)
    return torch.empty(ints, dtype=torch.int32, device=device) if ints else None


def _check_keys(x: torch.Tensor, what: str) -> tuple[int, int]:
    kernels.check_int32(x, what)
    lanes, n = kernels.lanes_of(x)
    if not 1 <= n < 2**31:
        raise ValueError(f"{what}: length {n} out of range")
    return lanes, n


def sorted_at(n_l: int, n_r: int) -> bool:
    """Whether the launcher lays out n_l left and n_r right keys on its
    sort-and-search path (the compare count 2 n_l n_r + n_l^2 / 2 above
    the compare path's threshold; 25 device launches instead of 1)."""
    return _scratch_ints("match_layout", 1, n_l, n_r) > 0


def match_layout_cuda(left_keys: torch.Tensor, right_keys: torch.Tensor):
    """(counts, first, b) per left row and cl per right row, on the card.
    The launcher picks its path by the lengths."""
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
    # the sort-and-search path's (key, index) pairs and histograms
    scratch = _scratch("match_layout", dev, lanes, n_l, n_r)
    device_launches = ctypes.c_int(0)
    fn = _launcher("match_layout",
                   (_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P))
    with torch.cuda.device(dev):
        err = fn(
            left_keys.data_ptr(), right_keys.data_ptr(), lanes, n_l, n_r,
            counts.data_ptr(), first.data_ptr(), b.data_ptr(), cl.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            ctypes.addressof(device_launches),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check_launch("match_layout", err)
    kernels.LAUNCHES["match_layout"] += 1
    kernels.DEVICE_LAUNCHES["match_layout"] += device_launches.value
    return counts, first, b, cl


def radix_at(n: int) -> bool:
    """Whether the launcher ranks n keys on its radix path (n above the
    compare path's threshold; 12 device launches instead of 1)."""
    return _scratch_ints("sort_ranks", 1, n) > 0


def sort_ranks_cuda(keys: torch.Tensor) -> torch.Tensor:
    """Each key's stable sorted position, on the card. The launcher picks
    its path by length."""
    lanes, n = _check_keys(keys, "keys")
    dev = keys.device
    rank = torch.empty(keys.shape, dtype=torch.int32, device=dev)
    if lanes == 0:
        return rank
    # the radix path's two (key, index) pairs and histograms, per lane
    scratch = _scratch("sort_ranks", dev, lanes, n)
    device_launches = ctypes.c_int(0)
    fn = _launcher("sort_ranks", (_P, _I, _I, _P, _P, _P, _P))
    with torch.cuda.device(dev):
        err = fn(
            keys.data_ptr(), lanes, n, rank.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            ctypes.addressof(device_launches),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check_launch("sort_ranks", err)
    kernels.LAUNCHES["sort_ranks"] += 1
    kernels.DEVICE_LAUNCHES["sort_ranks"] += device_launches.value
    return rank
