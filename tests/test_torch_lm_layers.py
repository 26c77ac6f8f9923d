"""The port's transformer layers (`repro_torch.models.layers`) against the
reference's (`repro.models.layers`) on the same seeded numpy inputs.

Tolerances: float32 outputs within rtol 1e-5 / atol 1e-5 (sums of at most
a few hundred float32 products of O(1) values, so a few ulps of order
apart); bfloat16 outputs within rtol 1e-2 / atol 1e-2 (a couple of bf16
ulps, eps 2^-8, where the two frameworks round intermediates apart).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro_torch.models import layers as TL

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=1e-2, atol=1e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

D, H, K, DH = 64, 4, 2, 16


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _pair(arr, dt):
    """The same values in both frameworks, cast to `dt` by each."""
    return jnp.asarray(arr).astype(JDT[dt]), torch.from_numpy(arr).to(TDT[dt])


def _close(got, want, dt):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), **TOL[dt]
    )


def _attn_params(rng, dt, bias):
    shapes = dict(wq=(D, H * DH), wk=(D, K * DH), wv=(D, K * DH), wo=(H * DH, D))
    arrs = {k: _rand(rng, s, s[0] ** -0.5) for k, s in shapes.items()}
    if bias:
        arrs.update(bq=_rand(rng, (H * DH,), 0.1), bk=_rand(rng, (K * DH,), 0.1),
                    bv=_rand(rng, (K * DH,), 0.1))
    pairs = {k: _pair(a, dt) for k, a in arrs.items()}
    return (RL.AttnParams(**{k: j for k, (j, _) in pairs.items()}),
            TL.AttnParams(**{k: t for k, (_, t) in pairs.items()}))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rms_norm(dt):
    rng = np.random.default_rng(0)
    xj, xt = _pair(_rand(rng, (3, 7, D), 2.0), dt)
    sj, st = _pair(_rand(rng, (D,), 0.3), dt)
    _close(TL.rms_norm(xt, st), RL.rms_norm(xj, sj), dt)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rope(dt, theta):
    rng = np.random.default_rng(1)
    xj, xt = _pair(_rand(rng, (2, 24, H, DH)), dt)
    pos = np.arange(3, 27, dtype=np.int32)[None, :]
    got = TL.rope(xt, torch.from_numpy(pos), theta)
    assert got.dtype == TDT[dt]
    _close(got, RL.rope(xj, jnp.asarray(pos), theta), dt)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("is_global", [False, True])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_attention_prefill_chunked_past_the_window(dt, is_global, bias):
    """48 tokens in three 16-key chunks, window 8: local layers mask whole
    chunks for late queries, the recurrence's NEG_INF start included."""
    rng = np.random.default_rng(2)
    pj, pt = _attn_params(rng, dt, bias)
    xj, xt = _pair(_rand(rng, (2, 48, D)), dt)
    kw = dict(n_heads=H, n_kv=K, d_head=DH, rope_theta=1e4,
              is_global=is_global, window=8, kv_chunk=16)
    got = TL.attention_prefill(pt, xt, **kw)
    assert got.dtype == TDT[dt]
    _close(got, RL.attention_prefill(pj, xj, **kw), dt)


def test_attention_prefill_refuses_a_partial_chunk():
    """The reference cannot reshape 40 keys into 16-key chunks; the port
    raises there rather than drop keys."""
    rng = np.random.default_rng(3)
    pj, pt = _attn_params(rng, "float32", False)
    xj, xt = _pair(_rand(rng, (1, 40, D)), "float32")
    kw = dict(n_heads=H, n_kv=K, d_head=DH, rope_theta=1e4, is_global=True,
              window=8, kv_chunk=16)
    with pytest.raises(TypeError):
        RL.attention_prefill(pj, xj, **kw)
    with pytest.raises(ValueError):
        TL.attention_prefill(pt, xt, **kw)


@pytest.mark.parametrize("is_global", [False, True])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_attention_decode(dt, is_global):
    rng = np.random.default_rng(4)
    pj, pt = _attn_params(rng, dt, True)
    xj, xt = _pair(_rand(rng, (2, 1, D)), dt)
    kcj, kct = _pair(_rand(rng, (2, 32, K, DH)), dt)
    vcj, vct = _pair(_rand(rng, (2, 32, K, DH)), dt)
    kw = dict(n_heads=H, n_kv=K, d_head=DH, rope_theta=1e6,
              is_global=is_global, window=8)
    want, kcj2, vcj2 = RL.attention_decode(pj, xj, kcj, vcj, jnp.int32(20), **kw)
    got, kct2, vct2 = TL.attention_decode(pt, xt, kct, vct, 20, **kw)
    _close(got, want, dt)
    _close(kct2, kcj2, dt)
    _close(vct2, vcj2, dt)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_swiglu_ffn(dt):
    rng = np.random.default_rng(5)
    ws = [_pair(_rand(rng, s, s[0] ** -0.5), dt) for s in ((D, 96), (D, 96), (96, D))]
    xj, xt = _pair(_rand(rng, (2, 5, D)), dt)
    want = RL.swiglu_ffn(RL.FFNParams(*[j for j, _ in ws]), xj)
    got = TL.swiglu_ffn(TL.FFNParams(*[t for _, t in ws]), xt)
    _close(got, want, dt)


def test_dense_init_scale_and_dtype():
    gen = torch.Generator().manual_seed(0)
    w = TL.dense_init(gen, (256, 512), 256, torch.bfloat16)
    assert w.dtype == torch.bfloat16 and w.shape == (256, 512)
    assert abs(float(w.float().std()) - 256**-0.5) < 2e-3
    again = TL.dense_init(torch.Generator().manual_seed(0), (256, 512), 256,
                          torch.bfloat16)
    assert torch.equal(w, again)
