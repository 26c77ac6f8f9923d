"""AdamW with global-norm clipping and a linear-warmup cosine schedule, as
`repro.optim.adamw`: m and v mirror the param tree in float32, the
update math runs in float32 and the result is cast back to each param's
dtype. The functions are functional (new tensors out, nothing updated in
place) and take no gradient.

Every scalar is a float32 tensor on the params' device, computed as the
reference computes it (`step` cast to float32, `b1 ** t` in float32):
Python floats would compute `0.9 ** t` in float64 and drift from it. No
scalar is read back to the host, so a step makes no host sync.

Across ranks (`specs` and `ranks`: the params are this rank's blocks, cut
by their specs, and the gradients already summed over each leaf's
replicas) the global norm counts each distinct element once, and m and
v follow ZeRO-1 (`specs.zero1_spec`, the reference's `_opt_specs`): a
leaf that a free dim lets cut over "data" keeps only this rank's slice
of m and v there, updates that slice of the param, and all-gathers the
param over "data".
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import tree as TT
from repro_torch.core import specs as S


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # Cross-replica gradient compression: cast grads to bf16 before the
    # optimizer sees them (the global norm included; update math stays f32).
    grad_compression_bf16: bool = True


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = step / max(1.0, cfg.warmup_steps)
    prog = (step - cfg.warmup_steps) / max(
        1.0, cfg.total_steps - cfg.warmup_steps
    )
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * torch.clamp(prog, 0.0, 1.0))
    )
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _data_size(ranks) -> int:
    return ranks.axis_size("data") if "data" in ranks.mesh.axis_names else 1


def mv_shape(p: torch.Tensor, spec: tuple, ranks) -> tuple:
    """The shape of this rank's m and v for param block `p` under ZeRO-1."""
    whole = S.whole_shape(p.shape, spec, ranks)
    return S.local_shape(whole, S.zero1_spec(spec, whole, _data_size(ranks)),
                         ranks)


def state_specs(params: Any, specs: Any, ranks) -> dict:
    """The spec tree of `adamw_init(params, specs, ranks)`'s state (the
    reference's `_opt_specs` of the whole params): m and v by ZeRO-1."""
    whole = S.map_leaves(lambda p, spec: torch.empty(
        S.whole_shape(p.shape, spec, ranks), device="meta"), params, specs)
    return S.opt_specs(specs, whole, _data_size(ranks))


def adamw_init(params: Any, specs: Any = None, ranks=None) -> dict:
    """Zero m and v (float32, each param's shape and device) and step 0
    (int32, on the first param's device). With `specs` and `ranks`, m and
    v are this rank's ZeRO-1 slices of its blocks' (`mv_shape`)."""
    def zeros(p, spec=None):
        shape = p.shape if ranks is None else mv_shape(p, spec, ranks)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def tree():
        if ranks is None:
            return TT.map(zeros, params)
        return S.map_leaves(zeros, params, specs)

    device = TT.leaves(params)[0].device
    return {
        "m": tree(),
        "v": tree(),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Any, specs: Any = None, ranks=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves
    summed in the reference's leaf order. Across ranks (`specs`, `ranks`;
    the leaves this rank's blocks) each distinct element counts once."""
    if ranks is not None:
        return torch.sqrt(S.sq_norm(tree, specs, ranks))
    sq = [torch.sum(g.to(torch.float32) ** 2) for g in TT.leaves(tree)]
    return torch.sqrt(sum(sq))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Any, state: dict, params: Any, *,
                 specs: Any = None, ranks=None):
    """Returns (new_params, new_state, metrics). Param dtype is preserved
    (bf16 params get f32 update math, then cast back). With `specs` and
    `ranks` the params and gradients are this rank's blocks (the
    gradients summed over their replicas); a leaf whose m is a ZeRO-1
    slice of its block is updated on that slice and all-gathered over
    "data"."""
    if cfg.grad_compression_bf16:
        grads = TT.map(lambda g: g.to(torch.bfloat16), grads)
    gnorm = global_norm(grads, specs, ranks)
    # a tensor divided, not `float / tensor` (torch's reciprocal-times form)
    scale = torch.clamp(
        torch.full_like(gnorm, cfg.clip_norm) / torch.clamp(gnorm, min=1e-12),
        max=1.0)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    t = step.to(torch.float32)
    bc1 = 1 - cfg.b1**t
    bc2 = 1 - cfg.b2**t

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(
            torch.float32
        )
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m, v

    def upd_slice(p, g, m, v):
        """upd on this rank's ZeRO-1 slice (the one dim where m is
        smaller than p), the new param all-gathered over "data"."""
        if ranks is None or m.shape == p.shape:
            return upd(p, g, m, v)
        k = next(i for i, (a, b) in enumerate(zip(m.shape, p.shape))
                 if a != b)
        lo = ranks.axis_index("data") * m.shape[k]
        new, m, v = upd(p.narrow(k, lo, m.shape[k]),
                        g.narrow(k, lo, m.shape[k]), m, v)
        return S.gather_dim(new, ranks.group("data"), k), m, v

    out = [upd_slice(p, g, m, v) for p, g, m, v in zip(
        TT.leaves(params), TT.leaves(grads), TT.leaves(state["m"]),
        TT.leaves(state["v"]))]
    new_p = TT.unflatten(params, [o[0] for o in out])
    new_m = TT.unflatten(params, [o[1] for o in out])
    new_v = TT.unflatten(params, [o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, {"m": new_m, "v": new_v, "step": step}, metrics
