"""Expert parallelism across processes (gloo ranks on the CPU, float32):
`moe_ffn_ep_local` at ep > 1 on (1, 4) and (2, 2) meshes over ("data",
"model"), the sharded one-hot decode, the reduced MoE LMs and `serve
--mode lm` with their experts over the ranks.

Oracles and tolerances:

- at capacity factor 8 (nothing drops) the dense JAX reference of
  tests/distributed/moe_ep_prog.py (every expert on every token,
  combined by the top-k gates), rebuilt here on one device: outputs and
  the gradients of every param and of x of a mean squared error within
  rtol / atol 1e-5 (the oracle program holds its shard_map EP to 2e-3;
  the port's float32 sums of a few hundred terms in another order hold
  to 1e-5). The router's gradient is summed over every rank (each uses
  it on its own tokens), an expert's over the data axis (its ranks hold
  the same experts);
- at capacity factors that drop, the reference's own EP under shard_map
  on 4 host devices (tests/distributed/moe_ep_drop_prog.py, in a
  subprocess): outputs within 1e-5 and the same drop count on every
  device (the same assignments drop);
- the sharded one-hot decode against the one-process one-hot within
  1e-5 (the same float32 sum split over the ranks), also at a capacity
  that drops;
- olmoe and granite-moe (reduced, float32, capacity factor 8 so neither
  run drops) at ep = 2 against the one-process port: prefill logits
  within 1e-5, greedy tokens equal; `serve --mode lm` under
  torch.distributed.run (2 ranks) prints the one-process server's tokens.
"""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as RM
from repro_torch.models import moe as TM
from repro_torch.models import transformer as T
from repro_torch.serve.decode import Generator

import _torch_model_ranks as MR
from test_torch_dist_ranks import run_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = [(1, 4), (2, 2)]
TOL = dict(rtol=1e-5, atol=1e-5)
E_PAD = 8


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory):
    return {mesh: run_ranks(tmp_path_factory.mktemp("ep"), 4,
                            "_torch_model_ranks:ep_prog", axis_sizes=mesh,
                            axis_names=("data", "model"))
            for mesh in MESHES}


@pytest.fixture(scope="module")
def lm_runs(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("lm"), 2,
                     "_torch_model_ranks:lm_prog", axis_sizes=(1, 2),
                     axis_names=("data", "model"))


def dense_moe_reference(p: RM.MoEParams, x, st: RM.MoESettings, e_pad: int):
    """tests/distributed/moe_ep_prog.py's oracle: every expert applied to
    every token, combined by the top-k gates (no capacity)."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    logits = xf.astype(jnp.float32) @ p.router.astype(jnp.float32)
    logits = jnp.where(jnp.arange(e_pad) < st.n_experts, logits, -jnp.inf)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, eidx = jax.lax.top_k(probs, st.top_k)
    gates = jnp.zeros_like(probs).at[
        jnp.arange(xf.shape[0])[:, None], eidx].set(gate_vals)
    g = jnp.einsum("td,edf->etf", xf, p.we_gate)
    u = jnp.einsum("td,edf->etf", xf, p.we_up)
    h = jax.nn.silu(g.astype(jnp.float32)) * u.astype(jnp.float32)
    eo = jnp.einsum("etf,efd->etd", h.astype(x.dtype), p.we_down)
    y = jnp.einsum("te,etd->td", gates.astype(jnp.float32),
                   eo.astype(jnp.float32))
    return y.astype(x.dtype).reshape(b, s, d)


def _ref_settings(cf):
    st = MR.moe_settings(cf)
    return RM.MoESettings(st.n_experts, st.top_k, st.d_expert_ff, cf)


def _tokens(blocks, mesh):
    """Rank blocks (batch over data, sequence over model) -> (B, S, ...)."""
    data, model = mesh
    return np.concatenate([np.concatenate(
        [blocks[d * model + m] for m in range(model)], axis=1)
        for d in range(data)], axis=0)


def _experts(blocks, mesh):
    """Per-rank expert grads -> every expert's, summed over the data axis."""
    data, model = mesh
    return np.concatenate([sum(blocks[d * model + m] for d in range(data))
                           for m in range(model)])


@pytest.mark.parametrize("mesh", MESHES)
def test_ep_matches_the_dense_reference(ep_runs, mesh):
    ranks = ep_runs[mesh]
    inp = MR.moe_inputs(0)
    p = RM.MoEParams(**{k: jnp.asarray(v) for k, v in inp["params"].items()})
    x, tgt = jnp.asarray(inp["x"]), jnp.asarray(inp["target"])
    st = _ref_settings(8.0)
    want = dense_moe_reference(p, x, st, E_PAD)
    got = _tokens([r["exact"]["y"] for r in ranks], mesh)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert all(r["exact"]["dropped"] == 0 for r in ranks)

    def loss(p, x):
        return jnp.mean((dense_moe_reference(p, x, st, E_PAD) - tgt) ** 2)

    gp, gx = jax.grad(loss, argnums=(0, 1))(p, x)
    grads = [r["exact"]["grads"] for r in ranks]
    np.testing.assert_allclose(sum(g["router"] for g in grads),
                               np.asarray(gp.router), **TOL)
    for k in ("we_gate", "we_up", "we_down"):
        np.testing.assert_allclose(_experts([g[k] for g in grads], mesh),
                                   np.asarray(getattr(gp, k)), **TOL)
    np.testing.assert_allclose(
        _tokens([r["exact"]["x_grad"] for r in ranks], mesh), np.asarray(gx),
        **TOL)


@pytest.fixture(scope="module")
def reference_ep(tmp_path_factory):
    """The reference's shard_map EP and drop counts on 4 host devices."""
    d = tmp_path_factory.mktemp("refep")
    arrays = {"meshes": np.array(MESHES)}
    for seed, cf, skew in MR.EP_DROP_CASES:
        inp = MR.moe_inputs(seed, skew, MR.DROP_EXPERTS, MR.DROP_SHAPE)
        key = f"{seed}-{cf}-{skew}"
        for k, v in inp["params"].items():
            arrays[f"{key}/{k}"] = v
        st = MR.moe_settings(cf, MR.DROP_EXPERTS)
        arrays.update({f"{key}/x": inp["x"], f"{key}/cf": cf,
                       f"{key}/n_experts": st.n_experts,
                       f"{key}/top_k": st.top_k})
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(ROOT / "tests/distributed/moe_ep_drop_prog.py"),
         str(d / "in.npz"), str(d / "out.npz")], env=env,
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("case", MR.EP_DROP_CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_ep_drops_what_the_reference_drops(ep_runs, reference_ep, mesh,
                                           case):
    ranks = ep_runs[mesh]
    key = f"{case[0]}-{case[1]}-{case[2]}/{mesh[0]}x{mesh[1]}"
    got = _tokens([r["drops"][case]["y"] for r in ranks], mesh)
    np.testing.assert_allclose(got, reference_ep[f"{key}/y"], **TOL)
    dropped = [r["drops"][case]["dropped"] for r in ranks]
    assert dropped == reference_ep[f"{key}/dropped"].tolist()
    assert sum(dropped) > 0


@pytest.mark.parametrize("capacity", [None, 2])
def test_sharded_onehot_decode(lm_runs, capacity):
    inp = MR.moe_inputs(4, skew=1.0)
    p = TM.MoEParams(**{k: torch.from_numpy(v)
                        for k, v in inp["params"].items()})
    x = MR.onehot_tokens(inp)
    want = TM.moe_ffn_onehot(p, x, MR.moe_settings(2.0), E_PAD, capacity)
    for r in lm_runs:
        np.testing.assert_allclose(r["onehot"][capacity], want.numpy(), **TOL)
    if capacity == 2:
        full = TM.moe_ffn_onehot(p, x, MR.moe_settings(2.0), E_PAD, 64)
        assert not torch.allclose(full, want)


@pytest.mark.parametrize("arch", MR.LM_ARCHS)
def test_reduced_moe_lm_at_ep2(lm_runs, arch):
    cfg = MR.lm_config(arch)
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    prompts = MR.lm_prompts(arch)
    with torch.no_grad():
        want = T.forward(params, torch.from_numpy(prompts), cfg)[0].numpy()
    one = Generator(cfg, params, device="cpu", max_len=24)
    tokens = one.generate(prompts, 8)
    assert int(one.moe_dropped) == 0
    for r in lm_runs:
        np.testing.assert_allclose(r[arch]["logits"], want, **TOL)
        np.testing.assert_array_equal(r[arch]["tokens"], tokens)
        assert r[arch]["dropped"] == 0


@pytest.mark.parametrize("arch", MR.LM_ARCHS)
def test_drop_count_once_per_forward(arch):
    """At a capacity factor that drops, `forward(dropped=)` adds each
    layer's drops once: the same count with remat and a backward (the
    block recomputed) as without, and `Generator.moe_dropped` is the last
    prefill's, not a sum over `start` calls."""
    cfg = dataclasses.replace(MR.lm_config(arch), capacity_factor=0.5)
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.from_numpy(MR.lm_prompts(arch))
    plain = torch.zeros((), dtype=torch.int64)
    with torch.no_grad():
        T.forward(params, tokens, cfg, dropped=plain)
    assert int(plain) > 0
    live = {k: v for k, v in params.items()}
    live["embed"] = params["embed"].clone().requires_grad_(True)
    remat = torch.zeros((), dtype=torch.int64)
    logits = T.forward(live, tokens, dataclasses.replace(cfg, remat=True),
                       dropped=remat)[0]
    logits.float().square().mean().backward()
    assert live["embed"].grad is not None
    assert int(remat) == int(plain)
    gen = Generator(cfg, params, device="cpu", max_len=24)
    for _ in range(2):
        gen.start(tokens.to(torch.int32))
        assert int(gen.moe_dropped) == int(plain)


def test_init_params_keeps_this_ranks_experts():
    """init_params(ranks=) is shard_params of the whole draw, and
    count_params(ep=) follows the reference's padding."""
    from repro.configs.registry import ARCHS as RARCHS
    from repro.models import transformer as RT
    from repro_torch.configs.registry import ARCHS

    import importlib

    class Ranks:  # a rank context's expert-axis surface
        mesh = types.SimpleNamespace(axis_names=("model",))

        def __init__(self, index):
            self.index = index

        def axis_size(self, axis):
            return 2

        def axis_index(self, axis):
            return self.index

    cfg = MR.lm_config("olmoe-1b-7b")
    whole = T.init_params(torch.Generator().manual_seed(0), cfg)
    for i in range(2):
        mine = T.init_params(torch.Generator().manual_seed(0), cfg,
                             ranks=Ranks(i))
        cut = T.shard_params(whole, Ranks(i), T.serve_specs(cfg))
        for (name, a), (_, b) in zip(T._leaves(mine), T._leaves(cut)):
            assert torch.equal(a, b), name
        assert mine["blocks"]["moe"]["we_gate"].shape[1] == 4
    for arch in ("olmoe-1b-7b", "granite-moe-3b-a800m"):
        mcfg = importlib.import_module(ARCHS[arch]).CONFIG
        rcfg = importlib.import_module(RARCHS[arch]).CONFIG
        for ep in (2, 4, 16):
            assert T.count_params(mcfg, ep) == RT.count_params(rcfg, ep)


def _serve(args: list[str], cwd) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("WORLD_SIZE", None)
    out = subprocess.run([sys.executable, *args], env=env, cwd=cwd,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_serve_lm_under_the_launcher_generates_as_one_process(tmp_path):
    serve = ["-m", "repro_torch.launch.serve", "--mode", "lm", "--arch",
             "olmoe-1b-7b", "--device", "cpu"]
    ranks = _serve(["-m", "torch.distributed.run", "--standalone",
                    "--nproc-per-node", "2", *serve], tmp_path)
    one = _serve(serve, tmp_path)
    assert "expert-parallel over 2 ranks, backend gloo" in ranks
    got = re.search(r"generated: .*", ranks, re.DOTALL).group(0)
    want = re.search(r"generated: .*", one, re.DOTALL).group(0)
    assert got == want and "(2, 16)" in want
