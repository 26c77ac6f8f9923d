"""Per-op byte counts of a traced step: the port's counterpart of XLA's
"bytes accessed" (`cost_analysis`), which the reference's dry-run reads.

`OpBytes` is a `TorchDispatchMode`: while entered it adds, for every op
dispatched below autograd, the bytes of its tensor inputs and outputs.
An op that only makes a view of its input (a reshape, a transpose, a
slice) moves nothing and is not counted. The hand-written kernels are
counted as one op each, whatever runs inside their wrappers (the CUDA
kernel through ctypes, the plain version on the CPU, a shape rule on
meta): each public wrapper runs under `kernel_call`, which hides the
ops within from every counter and adds its inputs and outputs once. So
a step counts the same bytes on meta tensors, on the CPU and on the
card.

Costs nothing when no counter is entered: `kernel_call` then only runs
the wrapper.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_COUNTERS: list["OpBytes"] = []
_HIDDEN = [0]  # > 0 inside a kernel wrapper


def nbytes(tree: Any) -> int:
    """The bytes of every tensor in `tree` (a vmapped tensor's whole
    batch, not one lane's)."""
    total = 0
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            while torch._C._functorch.is_batchedtensor(x):
                x = torch._C._functorch.get_unwrapped(x)
            total += x.numel() * x.element_size()
    return total


class OpBytes(TorchDispatchMode):
    """Counts `bytes` (inputs plus outputs of every op but views) and
    `ops`; `kernels` maps each kernel wrapper's name to its calls."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.kernels: dict[str, int] = {}

    def __enter__(self):
        _COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _COUNTERS.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _HIDDEN[0] and not func.is_view:
            self.bytes += nbytes((args, kwargs)) + nbytes(out)
            self.ops += 1
        return out

    def kernel(self, name: str, inputs, out) -> None:
        self.bytes += nbytes(inputs) + nbytes(out)
        self.ops += 1
        self.kernels[name] = self.kernels.get(name, 0) + 1


def kernel_call(name: str, fn: Callable, *args):
    """`fn(*args)`, counted by every entered `OpBytes` as one op of the
    tensors in `args` and its outputs."""
    if not _COUNTERS:
        return fn(*args)
    _HIDDEN[0] += 1
    try:
        out = fn(*args)
    finally:
        _HIDDEN[0] -= 1
    for counter in _COUNTERS:
        counter.kernel(name, args, out)
    return out
