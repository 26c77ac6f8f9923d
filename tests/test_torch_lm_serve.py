"""The port's LM serving path (`repro_torch.models.transformer`,
`repro_torch.serve.decode.Generator`, `serve --mode lm`) against the
reference's own functions, for the reduced config of every LM arch, with
the reference's weights carried across by `params_from_numpy`.

The reference runs under a (1, 1) mesh with Auto axes, built here:
`repro.launch.mesh.make_local_mesh` gives Explicit axes on this jax, on
which the reference's sharding constraints fail (its own
`test_archs_smoke.py::test_lm_smoke` cases do). Nothing of the reference
changes for it.

Tolerances: float32 configs — logits within rtol 1e-4 / atol 1e-4 and
greedy tokens equal (caches within the same tolerance); bfloat16 configs
— logits within atol 5e-2, no token equality asserted (bf16 rounds the
residual stream at every layer, and the frameworks round apart).
Granite's reduced config keeps a vocab that is not a multiple of 256 (500
of 512 rows), as its published 49,155 is, so the padding columns are
checked.
"""
import dataclasses
import importlib
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs.registry import ARCHS as REF_ARCHS
from repro.core import compat
from repro.launch.train import reduced_lm as ref_reduced_lm
from repro.models import transformer as RT
from repro.serve.decode import Generator as RefGenerator
from repro_torch.configs.registry import ARCHS, archs_of, family_of, lm_layer_count
from repro_torch.launch.train import reduced_lm
from repro_torch.models import transformer as T
from repro_torch.serve.decode import Generator

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
LM_ARCHS = archs_of("lm")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, S0, N_NEW = 2, 32, 8
MAX_LEN = S0 + N_NEW


def _vocab(arch):
    return 500 if arch == "granite-moe-3b-a800m" else 512


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


class Case:
    """One arch at one dtype: both configs, the reference's params and its
    jitted forward / prefill / decode steps, the port's params."""

    def __init__(self, arch, dt, mesh):
        jdt, tdt = DTYPES[dt]
        self.mesh = mesh
        self.rcfg = dataclasses.replace(ref_reduced_lm(
            importlib.import_module(REF_ARCHS[arch]).CONFIG, vocab=_vocab(arch)),
            dtype=jdt)
        self.cfg = dataclasses.replace(reduced_lm(
            importlib.import_module(ARCHS[arch]).CONFIG, vocab=_vocab(arch)),
            dtype=tdt)
        self.rparams = RT.init_params(jax.random.PRNGKey(0), self.rcfg, ep=1)
        self.np_params = jax.tree.map(np.asarray, self.rparams)
        self.params = T.params_from_numpy(self.np_params, self.cfg, "cpu")
        rng = np.random.default_rng(len(arch))
        self.prompts = rng.integers(0, self.cfg.vocab, (B, S0)).astype(np.int32)
        self.tokens = torch.from_numpy(self.prompts)
        cfg, m = self.rcfg, mesh
        self.ref_forward = jax.jit(lambda p, t: RT.forward(p, t, cfg, m, False)[:2])
        self.ref_gen = RefGenerator(self.rcfg, self.rparams, mesh, max_len=MAX_LEN)

    def ref(self, fn, *args):
        with compat.set_mesh(self.mesh):
            return fn(*args)


@pytest.fixture(scope="module")
def cases(mesh):
    made = {}

    def get(arch, dt):
        if (arch, dt) not in made:
            made[arch, dt] = Case(arch, dt, mesh)
        return made[arch, dt]

    return get


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def test_configs_copy_the_reference():
    for arch in LM_ARCHS:
        ref = importlib.import_module(REF_ARCHS[arch])
        mine = importlib.import_module(ARCHS[arch])
        assert mine.FAMILY == ref.FAMILY == family_of(arch) == "lm"
        a = dataclasses.asdict(ref.CONFIG)
        b = dataclasses.asdict(mine.CONFIG)
        assert a.pop("dtype") == jnp.bfloat16 and b.pop("dtype") == torch.bfloat16
        assert a == b
        assert lm_layer_count(arch) == ref.CONFIG.n_layers
        for ep in (1, 16):  # granite's 40 experts pad to 48 at ep 16
            assert T.count_params(mine.CONFIG, ep) == RT.count_params(ref.CONFIG, ep)
        assert T.model_flops(mine.CONFIG, "prefill", 2, 1024) == \
            RT.model_flops(ref.CONFIG, "prefill", 2, 1024)
        assert dataclasses.asdict(reduced_lm(mine.CONFIG)) | {"dtype": None} == \
            dataclasses.asdict(ref_reduced_lm(ref.CONFIG)) | {"dtype": None}
    assert T.count_params(importlib.import_module(ARCHS["gemma3-1b"]).CONFIG) == \
        (999_826_048, 999_826_048)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_params_has_the_reference_tree(arch):
    cfg = reduced_lm(importlib.import_module(ARCHS[arch]).CONFIG)
    rcfg = ref_reduced_lm(importlib.import_module(REF_ARCHS[arch]).CONFIG)
    mine = dict(T._leaves(T.init_params(torch.Generator().manual_seed(0), cfg)))
    ref = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        lambda k: RT.init_params(k, rcfg), jax.random.PRNGKey(0)))[0]
    ref = {"/".join(str(k.key) for k in path): a for path, a in ref}
    assert set(mine) == set(ref)
    for name, a in ref.items():
        assert tuple(mine[name].shape) == a.shape, name
        assert str(mine[name].dtype).split(".")[-1] == a.dtype.name, name
    if cfg.is_moe:  # one layer's experts copied to every layer, not a view
        w = T.init_params(torch.Generator().manual_seed(0), cfg)["blocks"]["moe"]
        assert torch.equal(w["we_up"][0], w["we_up"][1])
        w["we_up"][0].zero_()
        assert w["we_up"][1].any()


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_params_from_numpy_is_bit_exact(cases, arch, dt):
    c = cases(arch, dt)
    got = dict(T._leaves(c.params))
    dtypes = set()
    for path, arr in jax.tree_util.tree_flatten_with_path(c.np_params)[0]:
        name = "/".join(str(k.key) for k in path)
        t = got[name]
        assert t.device.type == "cpu" and tuple(t.shape) == arr.shape
        bits = np.int16 if arr.dtype.name == "bfloat16" else np.int32
        tbits = torch.int16 if bits is np.int16 else torch.int32
        np.testing.assert_array_equal(t.view(tbits).numpy(), arr.view(bits))
        dtypes.add(arr.dtype.name)
    # the MoE router stays float32 in a bf16 config
    assert dtypes == ({dt, "float32"} if c.cfg.is_moe else {dt})
    with pytest.raises(ValueError):
        T.params_from_numpy({"embed": c.np_params["embed"]}, c.cfg, "cpu")


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_logits(cases, arch, dt):
    c = cases(arch, dt)
    want, want_aux = c.ref(c.ref_forward, c.rparams, c.prompts)
    want = _f32(want)
    got, aux, _ = T.forward(c.params, c.tokens, c.cfg)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-4 if dt ==
                               "float32" else 5e-2, atol=1e-6)
    assert got.dtype == DTYPES[dt][1] and tuple(got.shape) == want.shape
    got = got.float().numpy()
    if dt == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)
    if c.cfg.padded_vocab != c.cfg.vocab:
        assert (got[..., c.cfg.vocab:] <= -1e29).all()


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_three_decode_steps(cases, arch):
    c = cases(arch, "float32")
    nxt_j, kcj, vcj = c.ref(c.ref_gen._prefill, c.rparams, jnp.asarray(c.prompts))
    prefill = T.make_prefill_step(c.cfg)
    nxt_t, kct, vct = prefill(c.params, c.tokens)
    np.testing.assert_array_equal(nxt_t.numpy(), np.asarray(nxt_j))
    for g, w in ((kct, kcj), (vct, vcj)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    # the reference's Generator cache layout: prefill K/V at [:S0]
    kc_r, vc_r = RT.init_decode_cache(c.rcfg, B, MAX_LEN)
    kc_r, vc_r = kc_r.at[:, :, :S0].set(kcj), vc_r.at[:, :, :S0].set(vcj)
    kc_t, vc_t = T.init_decode_cache(c.cfg, B, MAX_LEN)
    kc_t[:, :, :S0], vc_t[:, :, :S0] = kct, vct
    step = T.make_serve_step(c.cfg)
    for pos in range(S0, S0 + 3):
        nxt_j, kc_r, vc_r = c.ref(c.ref_gen._step, c.rparams, kc_r, vc_r,
                                  jnp.int32(pos), nxt_j)
        nxt_t, kc_t2, vc_t2 = step(c.params, kc_t, vc_t, pos, nxt_t)
        assert kc_t2 is kc_t and vc_t2 is vc_t  # updated in place
        np.testing.assert_array_equal(nxt_t.numpy(), np.asarray(nxt_j))
        np.testing.assert_allclose(kc_t.numpy(), np.asarray(kc_r), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(vc_t.numpy(), np.asarray(vc_r), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_generate(cases, arch):
    c = cases(arch, "float32")
    want = c.ref(c.ref_gen.generate, c.prompts, N_NEW)
    got = Generator(c.cfg, c.params, device="cpu", max_len=MAX_LEN).generate(
        c.prompts, N_NEW)
    assert got.dtype == np.int32 and got.shape == (B, N_NEW)
    np.testing.assert_array_equal(got, want)


def test_decode_logits_equal_a_cacheless_forward(cases):
    """The cached decode of token S0 + 1 against the forward over the grown
    sequence, at one 48-token (3-chunk) forward."""
    c = cases("gemma3-1b", "float32")
    gen = Generator(c.cfg, c.params, device="cpu", max_len=48)
    tokens = c.tokens
    with torch.inference_mode():
        nxt, kc, vc = gen.start(tokens)
        for pos in range(S0, 47):
            tokens = torch.cat([tokens, nxt[:, None]], dim=1)
            logits = T.decode_logits(gen.params, kc, vc, pos, nxt, c.cfg)
            nxt = torch.argmax(logits, -1).to(torch.int32)
        tokens = torch.cat([tokens, nxt[:, None]], dim=1)
        full, _, _ = T.forward(gen.params, tokens[:, :48], c.cfg)
    np.testing.assert_allclose(logits.numpy(), full[:, 46].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_prompt_lengths_the_reference_cannot_chunk_raise(cases):
    c = cases("qwen2.5-32b", "float32")
    prompts = np.zeros((1, 40), np.int32)  # > kv_chunk 16, not a multiple
    with pytest.raises(TypeError):
        c.ref(jax.jit(lambda p, t: RT.forward(p, t, c.rcfg, c.mesh, False)[0]),
              c.rparams, prompts)
    with pytest.raises(ValueError):
        T.forward(c.params, torch.from_numpy(prompts), c.cfg)
    gen = Generator(c.cfg, c.params, device="cpu", max_len=16)
    with pytest.raises(ValueError):
        gen.generate(np.zeros((1, 12), np.int32), 5)


def test_serve_lm_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "lm",
         "--arch", "gemma3-1b", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "generated: (2, 16)"
    rows = [np.array(ln.strip(" []").split(), int) for ln in lines[1:]]
    assert len(rows) == 2 and all(r.shape == (16,) for r in rows)
    # the same seeded weights in process give the same tokens
    cfg = reduced_lm(importlib.import_module(ARCHS["gemma3-1b"]).CONFIG)
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    want = Generator(cfg, params, device="cpu", max_len=64).generate(
        np.arange(8, dtype=np.int32).reshape(2, 4), 16)
    np.testing.assert_array_equal(np.stack(rows), want)


def test_serve_lm_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.serve_lm("gemma3-1b")
    cfg = reduced_lm(importlib.import_module(ARCHS["gemma3-1b"]).CONFIG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Generator(cfg, T.init_params(torch.Generator().manual_seed(0), cfg))
