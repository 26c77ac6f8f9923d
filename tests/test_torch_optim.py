"""The port's AdamW (`repro_torch.optim.adamw`) and parameter trees
(`repro_torch.tree`) against the reference's (`repro.optim.adamw`,
`jax.tree`) on the same seeded numpy params, grads and state, on the CPU.

Tolerances, in float32 ulps (units in the last place):
- the schedule within 2^-22 lr (jnp.cos and torch.cos are different
  approximations of the cosine, a few ulps of each other at most; near
  the end of the decay 1 + cos cancels, so an ulp of the cosine is many
  ulps of the rate, but never more than an ulp of lr);
- the global norm within 1 ulp (each leaf's sum of squares is a reduction
  in another order; the leaves are added in the reference's order);
- m and v within one rounding of their larger term: XLA's CPU backend
  contracts `b1 * m + (1 - b1) * g` into one fused multiply-add, the port
  rounds both products, so |Δm| <= 2^-23 (|b1 m| + |(1 - b1) g|), and the
  same for v;
- params within two roundings of |p| + |lr * delta| (the same FMA
  contraction in p - lr * delta and in delta, whose m and v carry the
  difference above);
- step and the zero state exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import adamw as RA
from repro_torch import tree as TT
from repro_torch.optim import adamw as TA

EPS32 = 2.0**-23
SHAPES = {"w": (17, 5), "blocks": {"b": (300,), "a": (4, 4, 3)},
          "layers": [{"z": (7,), "y": (2, 9)}, {"z": (7,), "y": (2, 9)}],
          "scale": ()}


def _tree(rng, scale=1.0, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(rng, scale, v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(rng, scale, v) for v in shapes]
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _ulps(got, want) -> int:
    """Largest distance in float32 ulps between two arrays."""
    a = np.asarray(got, np.float32).ravel().view(np.int32).astype(np.int64)
    b = np.asarray(want, np.float32).ravel().view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int(np.max(np.abs(a - b))) if a.size else 0


def _torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _configs(**changes):
    cfg = TA.AdamWConfig(warmup_steps=5, total_steps=30, **changes)
    return RA.AdamWConfig(**dataclasses.asdict(cfg)), cfg


def test_config_defaults_are_the_reference():
    assert dataclasses.asdict(TA.AdamWConfig()) == \
        dataclasses.asdict(RA.AdamWConfig())


@pytest.mark.parametrize("warmup,total", [(5, 30), (0, 10), (100, 10_000)])
def test_schedule_matches_reference(warmup, total):
    rcfg = RA.AdamWConfig(warmup_steps=warmup, total_steps=total)
    cfg = TA.AdamWConfig(warmup_steps=warmup, total_steps=total)
    steps = np.unique(np.r_[np.arange(0, 40), [warmup, total, total + 5,
                                                 9_999, 20_000]]).astype(np.int32)
    want = jax.vmap(lambda s: RA.schedule(rcfg, s))(jnp.asarray(steps))
    got = TA.schedule(cfg, torch.from_numpy(steps))
    assert got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= 2 * EPS32 * cfg.lr


def test_tree_leaf_order_is_jax_order():
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    want = jax.tree.leaves(tree)
    got = TT.leaves(tree)
    assert len(got) == len(want)
    assert all(g is w for g, w in zip(got, want))
    paths = TT.paths(tree)
    assert paths[:3] == ["blocks/a", "blocks/b", "layers[0]/y"]
    rebuilt = TT.unflatten(tree, list(range(len(got))))
    assert list(rebuilt) == list(tree)  # the caller's key order
    assert TT.leaves(rebuilt) == list(range(len(got)))
    with pytest.raises(ValueError):
        TT.unflatten(tree, list(range(len(got) + 1)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_init_matches_reference(dtype):
    rng = np.random.default_rng(1)
    tree = _tree(rng)
    if dtype == "bfloat16":
        tree = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), tree)
    want = RA.adamw_init(jax.tree.map(jnp.asarray, tree))
    got = TA.adamw_init(jax.tree.map(_torch, tree))
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 0
    for part in ("m", "v"):
        assert TT.paths(got[part]) == TT.paths(tree)
        for g, w in zip(TT.leaves(got[part]), jax.tree.leaves(want[part])):
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
            assert not g.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_matches_reference(dtype):
    rng = np.random.default_rng(2)
    for scale in (1e-3, 1.0, 50.0):
        tree = _tree(rng, scale)
        if dtype == "bfloat16":
            tree = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), tree)
        want = RA.global_norm(jax.tree.map(jnp.asarray, tree))
        got = TA.global_norm(jax.tree.map(_torch, tree))
        assert got.dtype == torch.float32
        assert _ulps(got.numpy(), want) <= 1


def _state(rng, step):
    m = _tree(rng, 0.1)
    v = jax.tree.map(np.abs, _tree(rng, 0.01))
    return m, v, np.int32(step)


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [0, 4, 5, 17, 40])
def test_adamw_update_matches_reference(step, dtype, compress):
    rng = np.random.default_rng(step * 4 + compress)
    rcfg, cfg = _configs(grad_compression_bf16=compress)
    params = _tree(rng)
    if dtype == "bfloat16":
        params = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), params)
    # large grads at odd steps: the clip is active there
    grads = _tree(rng, 3.0 if step % 2 else 0.01)
    m, v, st = _state(rng, step)
    rs = {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v),
          "step": jnp.asarray(st)}
    ts = {"m": jax.tree.map(_torch, m), "v": jax.tree.map(_torch, v),
          "step": torch.tensor(st)}
    rp, rs2, rm = jax.jit(lambda g, s, p: RA.adamw_update(rcfg, g, s, p))(
        jax.tree.map(jnp.asarray, grads), rs, jax.tree.map(jnp.asarray, params))
    tp, ts2, tm = TA.adamw_update(cfg, jax.tree.map(_torch, grads), ts,
                                  jax.tree.map(_torch, params))
    assert int(ts2["step"]) == int(rs2["step"]) == step + 1
    assert ts2["step"].dtype == torch.int32
    lr = float(rm["lr"])
    assert abs(float(tm["lr"]) - lr) <= 2 * EPS32 * cfg.lr
    assert _ulps(tm["grad_norm"].numpy(), rm["grad_norm"]) <= 1
    # params: |p| + |lr delta|, delta from the reference's new m and v
    t = step + 1
    for p, mm, vv, got, want in zip(
            jax.tree.leaves(params), jax.tree.leaves(rs2["m"]),
            jax.tree.leaves(rs2["v"]), TT.leaves(tp), jax.tree.leaves(rp)):
        assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                             else torch.float32)
        p64 = np.asarray(p, np.float64)
        mhat = np.asarray(mm, np.float64) / (1 - rcfg.b1**t)
        vhat = np.asarray(vv, np.float64) / (1 - rcfg.b2**t)
        delta = mhat / (np.sqrt(vhat) + rcfg.eps) + rcfg.weight_decay * p64
        term = np.abs(p64) + lr * np.abs(delta)
        ulp = 2.0**-8 if dtype == "bfloat16" else EPS32
        assert np.all(np.abs(_f32(got) - _f32(want)) <= 2 * ulp * term)
    # m and v: one rounding of their larger term apart (the FMA)
    g_used = [np.asarray(jnp.asarray(g, jnp.bfloat16 if compress
                                     else jnp.float32), np.float32)
              for g in jax.tree.leaves(grads)]
    clip = min(1.0, 1.0 / max(float(rm["grad_norm"]), 1e-12))
    for part, b in (("m", rcfg.b1), ("v", rcfg.b2)):
        olds = jax.tree.leaves({"m": m, "v": v}[part])
        for old, g, got, want in zip(olds, g_used, TT.leaves(ts2[part]),
                                     jax.tree.leaves(rs2[part])):
            gs = g * clip
            term = np.abs(b * old) + np.abs((1 - b) * (gs if part == "m"
                                                       else gs * gs))
            diff = np.abs(got.numpy() - np.asarray(want))
            assert np.all(diff <= 2 * EPS32 * term + 1e-30), part


def test_adamw_update_is_functional_and_takes_no_gradient():
    rng = np.random.default_rng(9)
    _, cfg = _configs()
    params = jax.tree.map(lambda a: _torch(a).requires_grad_(True), _tree(rng))
    before = [p.detach().clone() for p in TT.leaves(params)]
    state = TA.adamw_init(params)
    grads = jax.tree.map(_torch, _tree(rng))
    new_p, new_s, _ = TA.adamw_update(cfg, grads, state, params)
    assert all(torch.equal(p.detach(), b)
               for p, b in zip(TT.leaves(params), before))
    assert int(state["step"]) == 0 and not TT.leaves(state["m"])[0].any()
    assert not any(p.requires_grad for p in TT.leaves(new_p))
    assert int(new_s["step"]) == 1


def test_grad_of_a_tree_gives_zeros_where_the_loss_does_not_reach():
    params = {"a": torch.ones(3), "b": [torch.full((2,), 2.0), torch.ones(4)]}
    grads, aux = TT.grad(lambda p, k: ((p["a"] * k).sum()
                                       + (p["b"][0] ** 2).sum(),
                                       {"k": torch.tensor(k)}), params, 3.0)
    assert torch.equal(grads["a"], torch.full((3,), 3.0))
    assert torch.equal(grads["b"][0], torch.full((2,), 4.0))
    assert torch.equal(grads["b"][1], torch.zeros(4))
    assert float(aux["k"]) == 3.0
    assert not params["a"].requires_grad  # the caller's tensors untouched
