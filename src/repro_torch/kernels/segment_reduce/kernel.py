"""ctypes binding of the CUDA sorted segment sum (csrc/segment_sum.cu)."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels

NAME = "segment_reduce"
_P = ctypes.c_void_p
_I = ctypes.c_int
_ENTRY = {torch.float32: "segment_sum_f32_launch",
          torch.bfloat16: "segment_sum_bf16_launch"}


@functools.cache  # one lookup and argtypes setup per launcher
def _launcher(entry: str):
    fn = getattr(kernels.load(NAME, "segment_sum"), entry)
    fn.argtypes = [_P, _P, _I, _I, _I, _P, _P]
    fn.restype = _I
    return fn


def sorted_segment_sum_cuda(data: torch.Tensor, ids: torch.Tensor,
                            num_segments: int) -> torch.Tensor:
    """(num_segments, d) sums of `data`'s rows by sorted id, on the card, in
    the data's type (float32 or bfloat16), accumulated in float32."""
    if not data.is_cuda or data.dtype not in _ENTRY or data.dim() != 2:
        raise ValueError(
            "data: expected a 2-D float32 or bfloat16 CUDA tensor, got "
            f"{data.dtype} {tuple(data.shape)} on {data.device}"
        )
    if not data.is_contiguous():
        raise ValueError("data: expected a contiguous tensor")
    kernels.check_int32(ids, "ids")
    n, d = data.shape
    if ids.shape != (n,) or ids.device != data.device:
        raise ValueError("ids must be (n,) on data's device")
    if n >= 2**31 or not 1 <= d <= 65535 * 128 or not 0 <= num_segments < 2**31:
        raise ValueError(f"bad sizes: n={n} d={d} num_segments={num_segments}")
    out = torch.empty((num_segments, d), dtype=data.dtype, device=data.device)
    if num_segments == 0:
        return out
    dev = data.device
    with torch.cuda.device(dev):
        err = _launcher(_ENTRY[data.dtype])(
            data.data_ptr(), ids.data_ptr(), n, d, num_segments,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check_launch(NAME, err)
    kernels.LAUNCHES[NAME] += 1
    return out
