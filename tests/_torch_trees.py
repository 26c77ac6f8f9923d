"""Gradient comparison shared by the port's training tests.

Each gradient leaf is held to a relative L2 error of `bound` of its own
norm. The one exception is a leaf whose exact gradient is zero, such as
GAT's last `a_dst` when every score of a segment lies on one side of the
leaky ReLU (softmax does not see a shift shared by the whole segment).
Such a leaf carries float32 rounding only, so it is held to `bound` times
1e-4 of the whole gradient's norm. "Exact" is the port's own gradient
computed in float64 on the CPU (`float64_grad`); a leaf counts as zero
when its float64 norm is at most ZERO_REL of the whole float64 gradient's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import tree as TT

ZERO_REL = 1e-9
FLOOR_REL = 1e-4


def to_float64_cpu(x):
    """Every floating tensor in `x` (tensors, dicts, lists, tuples and
    named tuples such as GraphBatch) as float64 on the CPU."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.double() if x.is_floating_point() else x
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_float64_cpu(v) for v in x))
    if isinstance(x, dict):
        return {k: to_float64_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_float64_cpu(v) for v in x)
    return x


def float64_grad(loss_fn, params, *args, cfg):
    """The port's gradient of `loss_fn(params, *args, cfg)` in float64 on
    the CPU (a config's `compute_dtype` raised to float64 as well)."""
    if dataclasses.is_dataclass(cfg) and hasattr(cfg, "compute_dtype"):
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float64)
    return TT.grad(loss_fn, to_float64_cpu(params),
                   *to_float64_cpu(list(args)), cfg, has_aux=False)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, dtype=np.float64)


def assert_grads_close(name, paths, got, want, exact=None, bound=1e-4):
    """`got`, `want` and `exact` (or None: every leaf against its own norm)
    are leaves in the same order as `paths`: tensors or arrays."""
    got, want = [_np(g) for g in got], [_np(w) for w in want]
    assert len(got) == len(want) == len(paths), name
    zero = [False] * len(want)
    if exact is not None:
        exact = [_np(e) for e in exact]
        assert len(exact) == len(want), name
        total64 = float(np.sqrt(sum(float(np.sum(e * e)) for e in exact)))
        zero = [float(np.linalg.norm(e)) <= ZERO_REL * total64 for e in exact]
    total = float(np.sqrt(sum(float(np.sum(w * w)) for w in want)))
    for path, g, w, z in zip(paths, got, want, zero):
        assert g.shape == w.shape, (name, path, g.shape, w.shape)
        scale = FLOOR_REL * total if z else float(np.linalg.norm(w))
        err = float(np.linalg.norm(g - w))
        assert err <= bound * max(scale, 1e-30), (
            name, path, err, scale, "exact zero" if z else "own norm")
