"""The port's MoE dispatch (`repro_torch.models.moe`) against the
reference's (`repro.models.moe`) on the same seeded numpy inputs: the
routing plan and bucket packing exactly, the two MoE layers with
capacities small enough to drop rows (the same rows must drop), and the
load-balance loss.

The reference's sort-based layer runs inside `shard_map` over a (1, 1)
mesh with Auto axes (jax.make_mesh's default Explicit axes fail in its
sharding constraints on this jax), which is its one-expert-shard case,
the port's ep = 1.

Tolerances: float32 within rtol 1e-5 / atol 1e-5 (sums of at most a few
hundred float32 products of O(1) values); bfloat16 within rtol 2e-2 /
atol 2e-2 (the expert hidden and output round to bf16 twice).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType
from jax.sharding import PartitionSpec as P

from repro.core import compat
from repro.models import moe as RM
from repro_torch.models import moe as TM

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
D, FE = 32, 48


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


def _np(x):
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _params(rng, n_experts, e_pad, dt, skew=0.0):
    """Random experts; `skew` adds a bias toward expert 0 in the router so
    that capacities overflow."""
    router = rng.standard_normal((D, e_pad)).astype(np.float32) * D**-0.5
    router[:, 0] += skew
    arrs = dict(
        router=router,
        we_gate=rng.standard_normal((e_pad, D, FE)).astype(np.float32) * D**-0.5,
        we_up=rng.standard_normal((e_pad, D, FE)).astype(np.float32) * D**-0.5,
        we_down=rng.standard_normal((e_pad, FE, D)).astype(np.float32) * FE**-0.5,
    )
    j = RM.MoEParams(**{k: jnp.asarray(a).astype(jnp.float32 if k == "router" else JDT[dt])
                        for k, a in arrs.items()})
    t = TM.MoEParams(**{k: torch.from_numpy(a).to(torch.float32 if k == "router" else TDT[dt])
                        for k, a in arrs.items()})
    return j, t


def _x(rng, shape, dt, skew=0.0):
    x = rng.standard_normal(shape).astype(np.float32)
    x[..., 0] = np.abs(x[..., 0]) + skew
    return jnp.asarray(x).astype(JDT[dt]), torch.from_numpy(x).to(TDT[dt])


@pytest.mark.parametrize("cap", [3, 8, 40])
def test_route_plan_and_buckets(cap):
    rng = np.random.default_rng(cap)
    n, parts = 60, 5
    part = rng.integers(0, parts + 2, n).astype(np.int32)  # some out of range
    valid = rng.random(n) > 0.2
    want = RM.route_plan(jnp.asarray(part), jnp.asarray(valid), parts, cap)
    got = TM.route_plan(torch.from_numpy(part), torch.from_numpy(valid), parts, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    data = rng.standard_normal((n, 3)).astype(np.float32)
    jb = RM.scatter_to_buckets(jnp.asarray(data), *want, parts, cap)
    tb = TM.scatter_to_buckets(torch.from_numpy(data), *got, parts, cap)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    ids = np.arange(n, dtype=np.int32)
    np.testing.assert_array_equal(
        TM.scatter_to_buckets(torch.from_numpy(ids), *got, parts, cap).numpy(),
        np.asarray(RM.scatter_to_buckets(jnp.asarray(ids), *want, parts, cap)))
    back_j = RM.gather_from_buckets(jb, *want, n)
    back_t = TM.gather_from_buckets(tb, *got, n)
    np.testing.assert_array_equal(back_t.numpy(), np.asarray(back_j))
    if cap == 3:  # rows past the capacity dropped, and come back as zeros
        assert int(got[2].sum()) < int(valid.sum())
        assert (back_t.numpy() == 0).all(axis=1).sum() > (~valid).sum()


def test_top_k_breaks_ties_like_lax_top_k():
    x = np.random.default_rng(0).integers(0, 3, (500, 40)).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 8)
    tv, ti = TM.top_k(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _ref_ep_local(mesh, pj, xj, st):
    spec = RM.MoEParams(router=P(None, None), we_gate=P("model", None, None),
                        we_up=P("model", None, None), we_down=P("model", None, None))
    tok = P("data", "model", None)
    with compat.set_mesh(mesh):
        f = compat.shard_map(partial(RM.moe_ffn_ep_local, st=st, expert_axis="model"),
                             mesh=mesh, in_specs=(spec, tok), out_specs=tok,
                             check_vma=False)
        return jax.jit(f)(pj, xj)


@pytest.mark.parametrize("cf,skew", [(2.0, 0.0), (0.25, 0.0), (0.5, 3.0)])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_moe_ffn_ep_local_at_one_shard(mesh, dt, cf, skew):
    """Small capacity factors overflow the shard buffer (0.25: 40 slots for
    128 assignments) and the expert buckets (a router skewed toward expert
    0); the same rows must drop."""
    rng = np.random.default_rng(int(cf * 100) + int(skew))
    st_j = RM.MoESettings(8, 2, FE, cf)
    st_t = TM.MoESettings(8, 2, FE, cf)
    pj, pt = _params(rng, 8, 8, dt, skew)
    xj, xt = _x(rng, (2, 32, D), dt, skew)
    want = _ref_ep_local(mesh, pj, xj, st_j)
    got = TM.moe_ffn_ep_local(pt, xt, st_t)
    assert got.dtype == TDT[dt]
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL[dt])
    if cf < 1:  # some tokens lost every expert: their output is exactly 0
        dropped = (got.float().numpy() == 0).all(axis=-1)
        assert dropped.any()
        np.testing.assert_array_equal(dropped, (_np(want) == 0).all(axis=-1))


def test_moe_ffn_ep_local_refuses_several_shards():
    """Without a rank context the layer is one shard: one shard's experts
    of several (half the router's columns) are refused, not run as if
    they were every expert. The expert group comes from the ranks alone
    (tests/test_torch_dist_moe.py runs it at ep > 1)."""
    rng = np.random.default_rng(0)
    _, pt = _params(rng, 8, 8, "float32")
    _, xt = _x(rng, (1, 8, D), "float32")
    half = pt._replace(**{k: getattr(pt, k)[:4]
                          for k in ("we_gate", "we_up", "we_down")})
    with pytest.raises(ValueError, match="experts"):
        TM.moe_ffn_ep_local(half, xt, TM.MoESettings(8, 2, FE))
    with pytest.raises(TypeError):
        TM.moe_ffn_ep_local(pt, xt, TM.MoESettings(8, 2, FE), ep=2)


@pytest.mark.parametrize("capacity", [None, 2, 5])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_moe_ffn_onehot(dt, capacity):
    """Capacity 2 and 5 drop assignments past each expert's running count
    over the flattened (T·k) order; 10 experts padded to 12 (dead experts
    at -inf router logits)."""
    rng = np.random.default_rng(7 if capacity is None else capacity)
    st_j = RM.MoESettings(10, 3, FE)
    st_t = TM.MoESettings(10, 3, FE)
    pj, pt = _params(rng, 10, 12, dt, skew=1.0)
    xj, xt = _x(rng, (4, 4, D), dt, skew=1.0)
    want = RM.moe_ffn_onehot(pj, xj, st_j, 12, capacity)
    got = TM.moe_ffn_onehot(pt, xt, st_t, 12, capacity)
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL[dt])
    if capacity == 2:  # fewer experts' outputs than assignments survive
        full = TM.moe_ffn_onehot(pt, xt, st_t, 12, 64)
        assert not torch.allclose(full.float(), got.float())


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_moe_aux_loss(dt):
    rng = np.random.default_rng(9)
    st_j = RM.MoESettings(10, 3, FE)
    st_t = TM.MoESettings(10, 3, FE)
    pj, pt = _params(rng, 10, 12, dt)
    xj, xt = _x(rng, (2, 16, D), dt)
    want = float(RM.moe_aux_loss(pj, xj, st_j, 12))
    got = float(TM.moe_aux_loss(pt, xt, st_t, 12))
    assert abs(got - want) <= 1e-5 * abs(want) + 1e-6


def test_init_moe_params_pads_dead_experts_with_zeros():
    st = TM.MoESettings(40, 8, 16)
    p = TM.init_moe_params(torch.Generator().manual_seed(0), 24, st, 16,
                           torch.bfloat16)
    assert p.router.dtype == torch.float32 and p.router.shape == (24, 48)
    for w in (p.we_gate, p.we_up, p.we_down):
        assert w.shape[0] == 48 and w.dtype == torch.bfloat16
        assert not w[40:].any() and w[:40].abs().amax(dim=(1, 2)).gt(0).all()
