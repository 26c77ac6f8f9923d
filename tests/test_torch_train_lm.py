"""The training half of the port's LM (`repro_torch.models.transformer`:
`ce_loss`, `chunked_ce_loss`, `make_loss_fn`) against the reference's on
the same seeded numpy logits, tokens and weights (carried across by
`params_from_numpy`), on the CPU, for the reduced config of every LM arch
in float32. The reference runs under a (1, 1) mesh with Auto axes, as in
`test_torch_lm_serve.py`.

Tolerances: float32 losses within rtol 1e-4 / atol 1e-4; each gradient
leaf within a relative L2 error of 1e-4 (the LM port's float32
tolerance: a few hundred float32 products a dot, through 2 blocks) of
its own norm (`_torch_trees.assert_grads_close`; no leaf of these LMs has
an exact gradient of zero, so none is held to a floor);
`ce_loss` on float32 logits within rtol 1e-6 (the same float32
log-sum-exp in another order) and its gradient within relative L2 1e-6;
on bf16 logits the gradient within an ulp of bf16 (2^-8) relative L2.
Remat on against remat off within relative L2 1e-6 (autograd sums the
contributions to a tensor read twice in another order).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from _torch_trees import assert_grads_close

from repro.configs.registry import ARCHS as REF_ARCHS
from repro.core import compat
from repro.launch.train import reduced_lm as ref_reduced_lm
from repro.models import transformer as RT
from repro_torch import tree as TT
from repro_torch.configs.registry import ARCHS, archs_of
from repro_torch.launch.train import reduced_lm
from repro_torch.models import transformer as T

LM_ARCHS = archs_of("lm")
F32_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_REL_L2 = 1e-4


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


def _rel_l2(got, want) -> float:
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _assert_grads_close(got_tree, want_tree, bound=GRAD_REL_L2):
    assert_grads_close("grads", TT.paths(got_tree), TT.leaves(got_tree),
                       [np.asarray(jnp.asarray(w, jnp.float32))
                        for w in jax.tree.leaves(want_tree)], None, bound)


def _vocab(arch):
    return 500 if arch == "granite-moe-3b-a800m" else 512


def _lm_case(arch, **changes):
    """Both float32 configs, the reference's params and the port's copy of
    them, and a seeded batch of 4 x 32 tokens."""
    rcfg = dataclasses.replace(ref_reduced_lm(
        importlib.import_module(REF_ARCHS[arch]).CONFIG, vocab=_vocab(arch)),
        dtype=jnp.float32, **changes)
    cfg = dataclasses.replace(reduced_lm(
        importlib.import_module(ARCHS[arch]).CONFIG, vocab=_vocab(arch)),
        dtype=torch.float32, **changes)
    rparams = RT.init_params(jax.random.PRNGKey(1), rcfg, ep=1)
    params = T.params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, "cpu")
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, cfg.vocab, (2, 5, 33)).astype(np.int32)
    return rcfg, cfg, rparams, params, toks[0, :, :-1], toks[0, :, 1:]


def _logits(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    labels = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    j = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    t = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16"
                               else torch.float32)
    return j, t, labels


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ce_loss_and_gradient_match_reference(dtype):
    j, t, labels = _logits((3, 16, 300), dtype)
    want, want_nll = RT.ce_loss(j, jnp.asarray(labels))
    want_g = jax.grad(lambda x: RT.ce_loss(x, jnp.asarray(labels))[0])(j)
    x = t.clone().requires_grad_(True)
    got, got_nll = T.ce_loss(x, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(got_nll.detach()), float(want_nll),
                               rtol=1e-6)
    assert x.grad.dtype == t.dtype
    assert _rel_l2(x.grad, want_g) <= (2.0**-8 if dtype == "bfloat16"
                                       else 1e-6)


def test_ce_loss_label_logit_goes_through_bf16():
    """The label's logit is read at bf16 precision, value and gradient:
    the -1/n cotangent of the label term is rounded to bf16."""
    logits = torch.tensor([[[0.0, 1.0 + 2.0**-10, 0.5]]], requires_grad=True)
    labels = torch.tensor([[1]], dtype=torch.int32)
    total, nll = T.ce_loss(logits, labels, z_loss=0.0)
    lse = torch.logsumexp(logits.detach(), -1)
    assert float(nll.detach()) == float(lse - 1.0)  # 1 + 2^-10 rounds to 1 in bf16
    total.backward()
    p = torch.softmax(logits.detach(), -1)
    assert torch.allclose(logits.grad[0, 0], p[0, 0] - torch.tensor([0, 1, 0]))


@pytest.mark.parametrize("ce_chunk,vocab", [(8, 512), (0, 512), (8, 500),
                                            (12, 500)])
def test_chunked_ce_loss_matches_reference(ce_chunk, vocab):
    """Chunks of 8 over S = 32, one chunk (0, or 12 not dividing 32), and a
    padded vocab (500 of 512 columns live)."""
    rcfg = RT.TransformerConfig(name="t", n_layers=1, d_model=24, n_heads=2,
                                n_kv_heads=2, d_head=12, d_ff=32, vocab=vocab,
                                ce_chunk=ce_chunk, dtype=jnp.float32)
    cfg = T.TransformerConfig(name="t", n_layers=1, d_model=24, n_heads=2,
                              n_kv_heads=2, d_head=12, d_ff=32, vocab=vocab,
                              ce_chunk=ce_chunk, dtype=torch.float32)
    rng = np.random.default_rng(ce_chunk + vocab)
    x = rng.standard_normal((2, 32, 24)).astype(np.float32)
    head = (rng.standard_normal((24, 512)) * 0.3).astype(np.float32)
    labels = rng.integers(0, vocab, (2, 32)).astype(np.int32)

    def ref(x, h):
        return RT.chunked_ce_loss(x, h, jnp.asarray(labels), rcfg)

    want, want_nll = ref(jnp.asarray(x), jnp.asarray(head))
    gx, gh = jax.grad(lambda a, b: ref(a, b)[0], argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head))
    tx = torch.from_numpy(x).requires_grad_(True)
    th = torch.from_numpy(head).requires_grad_(True)
    got, got_nll = T.chunked_ce_loss(tx, th, torch.from_numpy(labels), cfg)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **F32_TOL)
    np.testing.assert_allclose(float(got_nll.detach()), float(want_nll),
                               **F32_TOL)
    assert _rel_l2(tx.grad, gx) <= GRAD_REL_L2
    assert _rel_l2(th.grad, gh) <= GRAD_REL_L2
    if vocab < 512:  # the dead padding columns get no gradient
        assert not th.grad[:, vocab:].any()


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_gradients_match_reference(arch, mesh):
    """make_loss_fn's value, metrics and gradient of every param leaf.
    qwen2.5-32b and deepseek-67b keep ce_chunk = 1024, so their loss takes
    the chunked path (one chunk at S = 32)."""
    rcfg, cfg, rparams, params, tokens, labels = _lm_case(arch)
    loss_fn = RT.make_loss_fn(rcfg, mesh, False)
    with compat.set_mesh(mesh):
        (want, rm), want_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            rparams, jnp.asarray(tokens), jnp.asarray(labels))
    got_g, m = TT.grad(T.make_loss_fn(cfg), params, torch.from_numpy(tokens),
                       torch.from_numpy(labels))
    got, _ = T.make_loss_fn(cfg)(params, torch.from_numpy(tokens),
                                 torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), **F32_TOL)
    for k in ("loss", "aux"):
        np.testing.assert_allclose(float(m[k]), float(rm[k]), **F32_TOL)
    if cfg.is_moe:
        assert float(m["aux"]) > 0
        assert bool(got_g["blocks"]["moe"]["router"].any())  # aux and gates
    _assert_grads_close(got_g, want_g)


@pytest.mark.parametrize("arch", ["gemma3-1b", "olmoe-1b-7b"])
def test_remat_gives_the_same_loss_and_gradients(arch):
    _, cfg, _, params, tokens, labels = _lm_case(arch)
    assert cfg.remat  # the configs' default
    args = (torch.from_numpy(tokens), torch.from_numpy(labels))
    g_remat, m_remat = TT.grad(T.make_loss_fn(cfg), params, *args)
    plain = dataclasses.replace(cfg, remat=False)
    g_plain, m_plain = TT.grad(T.make_loss_fn(plain), params, *args)
    assert float(m_remat["loss"]) == float(m_plain["loss"])
    for path, a, b in zip(TT.paths(g_plain), TT.leaves(g_plain),
                          TT.leaves(g_remat)):
        assert float((a - b).norm()) <= 1e-6 * float(a.norm()) + 1e-12, path


def test_serving_forward_is_unchanged_by_remat():
    """Without a gradient (serving) the blocks run plainly: the same
    logits, bit for bit, with remat on or off."""
    _, cfg, _, params, tokens, _ = _lm_case("gemma3-1b")
    with torch.inference_mode():
        a = T.forward(params, torch.from_numpy(tokens), cfg)[0]
        b = T.forward(params, torch.from_numpy(tokens),
                      dataclasses.replace(cfg, remat=False))[0]
    assert torch.equal(a, b)
