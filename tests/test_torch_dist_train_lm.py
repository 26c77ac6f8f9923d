"""The LM train step across ranks (4 gloo ranks on the CPU, one spawn
over the meshes (data 2, model 2), (4, 1) and (1, 4)), held to the
one-process port's step and to the reference's.

- `param_specs`, `zero1_spec` and `_opt_specs` equal the reference's
  for the five LM configs at model sizes 1, 2 and 4 (data size 4);
- on the reference's mesh program's config (tests/distributed/
  lm_mesh_prog.py) in float32, dense and MoE (ep = model size), with and
  without FSDP and sequence sharding, a one-KV-head config (gemma3-1b's:
  wk and wv whole on "model", qk-norm, tied and scaled embeddings, local
  layers, the chunked loss), every step clipping: the loss, grad_norm
  and the params (the relative L2 error of the whole tree) within 1e-5
  of the one-process step after each of two steps, and each param leaf
  within 1e-3 of its own norm. AdamW's first steps divide each element
  by its own magnitude plus eps (1e-8), and many of the embedding's
  gradient elements are 0 or near 1e-8, so the sums' order moves such an
  element by up to lr (2.6e-6 of a leaf at most here, 5.5e-5 of a
  zero-initialized norm weight on other batches); a wrong or missing
  gradient moves a leaf by O(lr) in every element, O(1) of a
  zero-initialized leaf. m and v are ZeRO-1 slices;
- at one rank the step is the one-process step, bit for bit;
- the loss on those weights and batch is within rtol 2e-3 of the
  reference's sharded loss on a (data 2, model 2) mesh of 4 host devices
  (tests/distributed/lm_train_mesh_prog.py, in a subprocess);
- `split_replicated`'s cross-rank Jacobian (its input one replicated
  variable, each rank's gradient the whole) and the replicated region's
  (the MoE block's form at ep > 1 in training: a narrow to this rank's
  slice and the differentiable all-gather, for code whose ranks hold
  parts of a gradient, their sum the whole) equal their backwards within
  1e-6 in float64.
"""
import importlib
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import registry as RR
from repro.models import transformer as RT
from repro_torch import tree as TT
from repro_torch.configs import registry as TR
from repro_torch.core import specs as S
from repro_torch.models import transformer as T

import _torch_train_ranks as TRR
from test_torch_dist_ranks import run_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
LM_ARCHS = TR.archs_of("lm")
RTOL = 1e-5
LEAF_RTOL = 1e-3
JAC_TOL = dict(rtol=0, atol=1e-6)
ORACLE_RTOL = 2e-3


def _ref_config(arch):
    return importlib.import_module(RR.ARCHS[arch]).CONFIG


def _port_config(arch):
    return importlib.import_module(TR.ARCHS[arch]).CONFIG


@pytest.mark.parametrize("model", [1, 2, 4])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_specs_follow_the_reference(arch, model):
    want = RT.param_specs(_ref_config(arch), False, model)
    got = T.param_specs(_port_config(arch), False, model)
    flat = jax.tree.leaves(want, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    assert S.spec_leaves(got, T.init_params(None, _port_config(arch),
                                            device="meta")) == \
        [tuple(p) for p in flat]
    assert T.dp_axes(True) == RT.dp_axes(True)
    assert T.dp_axes(False) == RT.dp_axes(False)


@pytest.mark.parametrize("model", [1, 2, 4])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_zero1_and_opt_specs_follow_the_reference(arch, model):
    data = 4
    rcfg, cfg = _ref_config(arch), _port_config(arch)
    shapes = jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0),
                                                   rcfg, ep=model))
    pspecs = RT.param_specs(rcfg, False, model)
    want = RR._opt_specs(pspecs, shapes, data)
    meta = T.init_params(None, cfg, ep=model, device="meta")
    got = TR._opt_specs(T.param_specs(cfg, False, model), meta, data)
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    for k in ("m", "v"):
        assert S.spec_leaves(got[k], meta) == [
            tuple(p) for p in jax.tree.leaves(want[k], is_leaf=is_p)]
    assert got["step"] == tuple(want["step"]) == ()
    for spec, shape in zip(jax.tree.leaves(pspecs, is_leaf=is_p),
                           jax.tree.leaves(shapes)):
        assert TR.zero1_spec(tuple(spec), shape.shape, data) == tuple(
            RR.zero1_spec(spec, shape.shape, data))


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("train_lm"), 4,
                     "_torch_train_ranks:lm_train_prog", axis_sizes=(4,),
                     axis_names=("world",), timeout=300)


@pytest.fixture(scope="module")
def one_process():
    cache = {}

    def get(case, model):
        if (case, model) not in cache:
            cache[case, model] = TRR.one_process_steps(
                TRR.lm_config(*case), model)
        return cache[case, model]

    return get


def assert_params_close(got: list, want: list):
    """The whole tree within RTOL (relative L2), each leaf within
    LEAF_RTOL of its norm."""
    diff2 = norm2 = 0.0
    for a, b in zip(got, want):
        assert a.shape == b.shape
        d, n = float(np.linalg.norm(a - b)), float(np.linalg.norm(b))
        assert d <= LEAF_RTOL * n, d / n
        diff2, norm2 = diff2 + d * d, norm2 + n * n
    assert (diff2 / norm2) ** 0.5 <= RTOL, (diff2 / norm2) ** 0.5


@pytest.mark.parametrize("case", TRR.LM_CASES,
                         ids=["-".join(map(str, c)) for c in TRR.LM_CASES])
@pytest.mark.parametrize("mesh", TRR.MESHES, ids=str)
def test_train_step_across_ranks_equals_one_process(mesh_runs, one_process,
                                                    mesh, case):
    key = (mesh, *case)
    want = one_process(case, mesh[1])
    for rank in mesh_runs:
        got = rank[key]["steps"]
        for g, w in zip(got, want):
            assert w["grad_norm"] > TRR.OPT.clip_norm  # the step clips
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       rtol=RTOL)
            np.testing.assert_allclose(g["aux"], w["aux"], rtol=RTOL,
                                       atol=1e-7)
            assert_params_close(g["params"], w["params"])


@pytest.mark.parametrize("mesh", TRR.MESHES, ids=str)
def test_m_and_v_are_zero1_slices(mesh_runs, mesh):
    for case in TRR.LM_CASES:
        for rank in mesh_runs:
            got = rank[(mesh, *case)]
            assert got["mv"] == got["mv_want"]
            if mesh[0] > 1:  # ZeRO-1 cut something finer than the params
                assert sum(map(np.prod, got["mv"])) < sum(
                    map(np.prod, got["local"]))
            else:
                assert got["mv"] == got["local"]


def test_at_one_rank_the_step_is_the_one_process_step(tmp_path):
    (got,) = run_ranks(tmp_path, 1, "_torch_train_ranks:one_rank_prog",
                       axis_sizes=(1, 1), axis_names=("data", "model"))
    for kind, (plain, ranked) in got.items():
        for a, b in zip(plain["params"], ranked["params"]):
            np.testing.assert_array_equal(a, b)
        for k in plain["metrics"]:
            np.testing.assert_array_equal(plain["metrics"][k],
                                          ranked["metrics"][k])


def _reference_losses(tmp_path) -> dict:
    cfg = TRR.lm_config("moe")
    params = TRR.lm_params(cfg, 2)
    arrays = {f"p/{n}": v.numpy()
              for n, v in zip(TT.paths(params), TT.leaves(params))}
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head",
              "d_ff", "vocab", "n_experts", "top_k", "d_expert_ff",
              "kv_chunk", "capacity_factor"):
        arrays[f"cfg/{f}"] = np.asarray(getattr(cfg, f))
    arrays.update(TRR.lm_batches(cfg, 1)[0])
    np.savez(tmp_path / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(ROOT / "tests/distributed/lm_train_mesh_prog.py"),
         str(tmp_path / "in.npz"), str(tmp_path / "out.npz")], env=env,
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    return {k: float(v) for k, v in np.load(tmp_path / "out.npz").items()}


def test_loss_is_the_reference_mesh_programs(mesh_runs, tmp_path):
    ref = _reference_losses(tmp_path)
    # the reference's own sharding invariance
    np.testing.assert_allclose(ref["mesh_loss"], ref["one_loss"],
                               rtol=ORACLE_RTOL)
    got = mesh_runs[0][((2, 2), "moe", False, True)]["steps"][0]
    for k in ("mesh_loss", "one_loss", "step_loss"):
        np.testing.assert_allclose(got["loss"], ref[k], rtol=ORACLE_RTOL)
    np.testing.assert_allclose(got["aux"], ref["mesh_aux"], rtol=ORACLE_RTOL)


@pytest.fixture(scope="module")
def replicated_runs(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("replicated"), 4,
                     "_torch_train_ranks:replicated_prog",
                     axis_sizes=(2, 2), axis_names=("data", "model"))


def test_split_replicated_takes_each_ranks_slice(replicated_runs):
    x = TRR.replicated_inputs(4)["x"]
    for r, got in enumerate(replicated_runs):
        np.testing.assert_array_equal(got["split"], x[:, 2 * r:2 * r + 2])


@pytest.mark.parametrize("name", ["split_jac", "region_jac"])
def test_replicated_pair_jacobians_match_the_backward(replicated_runs, name):
    num = np.concatenate([r[name][0] for r in replicated_runs], axis=1)
    for r in replicated_runs:
        ana = r[name][1]
        assert ana.shape == num.T.shape and num.any()
        np.testing.assert_allclose(ana, num.T, **JAC_TOL)
