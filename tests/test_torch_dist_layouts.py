"""The layouts the reference's cells use, across ranks (4 gloo ranks on
the CPU, meshes (data 2, model 2) and (1, 4)), held to the one-process
port. Every tolerance below is in float32.

- Tensor-parallel prefill (the reference's prefill cells: the params cut
  by `param_specs`, `MeshLayout`'s forward with the cache collected):
  the last position's logits (every vocab shard gathered) within rtol /
  atol 1e-5 of the one-process forward's, this rank's KV cache (its
  rows and its KV heads; all of them where the heads do not split over
  "model" and the attention runs sequence-parallel) within 1e-5, and the
  step's next tokens the one-process argmax. Configs: the reduced dense
  and MoE LMs, one KV head with qk-norm and local layers ("gqa1"), and 6
  heads, which do not split over 4 model ranks ("h6").
- Decode with the KV cache cut on its sequence dim (the reference's
  decode cells): over "model" with the batch over "data" (b = 4) and
  over every axis for one sequence (b = 1); three steps, each step's
  logits within rtol / atol 1e-5 of the one-process decode's, the next
  tokens their argmax, and this rank's block of the cache after the
  steps within 1e-5 of the one-process cache's.
- The GNN train step in the edge cut (the reference's cells of every
  graph under a million nodes: each rank a slice of every edge set,
  every node table whole): GAT, SchNet, MeshGraphNet and GraphCast at
  their reduced configs, one step, the params within 1e-5 (relative L2
  of the tree) and each leaf within 1e-3 of its norm, grad_norm within
  1e-5 relative (the bounds of test_torch_dist_train_models.py), the
  same on every rank. GraphCast runs in float64: its reduced config's
  float32 gradients are good to 1.9e-4 (relative L2 against float64 in
  one process), so no other order of their sums could meet 1e-5; in
  float64 the edge cut's gradients equal one process's to 4.5e-8 (its
  layer norms compute in float32).

Each layout is also held to the reference's step in the same layout on
the same inputs: tests/distributed/cells_mesh_prog.py `layouts` runs the
reference's prefill, serve and GNN train steps on 4 host devices over
the same two meshes, its inputs placed as its cells place them (params
by `param_specs`, the prompt over "data", the decode cache on its
sequence dim as the decode cells cut it, every edge set over every axis
with the node tables whole). The next tokens equal the reference's; the
caches are within rtol / atol 1e-5 of its (they agree to 2.1e-6); the
GNN step's grad_norm within 1e-5 relative and its params within the
bounds above (GraphCast's reference runs in float32: its params after
the step agree to 3.2e-6, relative L2 of the tree 1.6e-7).
"""
import jax  # noqa: F401  (test files import both frameworks)
import numpy as np
import pytest

import _torch_cell_ranks as CR
from test_torch_dist_ranks import run_ranks
from test_torch_dist_train_lm import assert_params_close

TOL = dict(rtol=1e-5, atol=1e-5)
RTOL = 1e-5
DECODE = [(m, k, b) for m in CR.LAYOUT_MESHES for k, b in CR.DECODE_CASES
          if b % m[0] == 0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("layouts"), 4,
                     "_torch_cell_ranks:layouts_prog", axis_sizes=(4,),
                     axis_names=("world",), timeout=400)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return CR.reference_cells("layouts",
                              tmp_path_factory.mktemp("layouts_ref"))


def _tag(mesh) -> str:
    return "x".join(map(str, mesh))


@pytest.mark.parametrize("kind", CR.PREFILL_KINDS)
@pytest.mark.parametrize("mesh", CR.LAYOUT_MESHES, ids=str)
def test_tensor_parallel_prefill_equals_one_process(runs, mesh, kind):
    want = CR.one_process_prefill(kind, mesh[1])
    for got in (r[("prefill", mesh, kind)] for r in runs):
        rows = slice(got["row0"], got["row0"] + got["logits"].shape[0])
        np.testing.assert_allclose(got["logits"], want["logits"][rows], **TOL)
        np.testing.assert_array_equal(got["next"], want["next"][rows])
        for k in ("kc", "vc"):
            np.testing.assert_allclose(
                got[k], want[k][:, rows][:, :, :, got["heads"]], **TOL)
        np.testing.assert_array_equal(got["kc_step"], got["kc"])
    if kind == "h6":  # 6 heads split over 2, not over 4
        assert runs[0][("prefill", mesh, kind)]["heads_tp"] == (mesh[1] == 2)


def _block(whole: np.ndarray, mesh, rank: int, cache_spec) -> np.ndarray:
    """Rank `rank`'s block of a whole cache (L, B, S, K, Dh) on a ("data",
    "model") mesh of `mesh` sizes, cut by `cache_spec`."""
    d, m = divmod(rank, mesh[1])
    x = whole
    if cache_spec[1] is not None:  # the batch over "data"
        n = x.shape[1] // mesh[0]
        x = x[:, d * n:(d + 1) * n]
    axes = cache_spec[2]
    k, index = (mesh[1], m) if axes == "model" else (mesh[0] * mesh[1], rank)
    n = x.shape[2] // k
    return x[:, :, index * n:(index + 1) * n]


@pytest.mark.parametrize("mesh,kind,batch", DECODE,
                         ids=[f"{m}-{k}-b{b}" for m, k, b in DECODE])
def test_sequence_cut_decode_equals_one_process(runs, mesh, kind, batch):
    want = CR.one_process_decode(kind, batch, mesh[1])
    for rank, r in enumerate(runs):
        got = r[("decode", mesh, kind, batch)]
        d = rank // mesh[1]
        n = batch // mesh[0] if batch > 1 else batch
        rows = slice(d * n, (d + 1) * n) if batch > 1 else slice(None)
        for g, w, nxt in zip(got["logits"], want["logits"], got["next"]):
            np.testing.assert_allclose(g, w[rows], **TOL)
            np.testing.assert_array_equal(nxt, np.argmax(w[rows], axis=-1))
        for k in ("kc", "vc"):
            np.testing.assert_allclose(
                got[k], _block(want[k], mesh, rank, got["cache_spec"]), **TOL)


@pytest.mark.parametrize("arch", [c[0] for c in CR.GNN_EDGE_CASES])
@pytest.mark.parametrize("mesh", CR.LAYOUT_MESHES, ids=str)
def test_edge_cut_gnn_train_step_equals_one_process(runs, mesh, arch):
    case = next(c for c in CR.GNN_EDGE_CASES if c[0] == arch)
    want = CR.one_process_gnn(case)
    first = runs[0][("gnn", mesh)][arch]
    for r in runs:
        got = r[("gnn", mesh)][arch]
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=RTOL)
        assert_params_close(got["params"], want["params"])
        for a, c in zip(got["params"], first["params"]):
            np.testing.assert_array_equal(a, c)  # one step on every rank


@pytest.mark.parametrize("kind", CR.PREFILL_KINDS)
@pytest.mark.parametrize("mesh", CR.LAYOUT_MESHES, ids=str)
def test_tensor_parallel_prefill_is_the_reference_cells(runs, reference,
                                                        mesh, kind):
    key = f"prefill/{_tag(mesh)}/{kind}"
    for got in (r[("prefill", mesh, kind)] for r in runs):
        rows = slice(got["row0"], got["row0"] + got["next"].shape[0])
        np.testing.assert_array_equal(got["next"],
                                      reference[f"{key}/next"][rows])
        for k in ("kc", "vc"):
            np.testing.assert_allclose(
                got[k], reference[f"{key}/{k}"][:, rows][:, :, :,
                                                          got["heads"]],
                **TOL)


@pytest.mark.parametrize("mesh,kind,batch", DECODE,
                         ids=[f"{m}-{k}-b{b}" for m, k, b in DECODE])
def test_sequence_cut_decode_is_the_reference_cells(runs, reference, mesh,
                                                    kind, batch):
    key = f"decode/{_tag(mesh)}/{kind}/{batch}"
    for rank, r in enumerate(runs):
        got = r[("decode", mesh, kind, batch)]
        d = rank // mesh[1]
        n = batch // mesh[0] if batch > 1 else batch
        rows = slice(d * n, (d + 1) * n) if batch > 1 else slice(None)
        for i, nxt in enumerate(got["next"]):
            np.testing.assert_array_equal(nxt,
                                          reference[f"{key}/next{i}"][rows])
        for k in ("kc", "vc"):
            np.testing.assert_allclose(
                got[k], _block(reference[f"{key}/{k}"], mesh, rank,
                               got["cache_spec"]), **TOL)


@pytest.mark.parametrize("arch", [c[0] for c in CR.GNN_EDGE_CASES])
@pytest.mark.parametrize("mesh", CR.LAYOUT_MESHES, ids=str)
def test_edge_cut_gnn_train_step_is_the_reference_cells(runs, reference,
                                                        mesh, arch):
    key = f"gnn/{_tag(mesh)}/{arch}"
    for r in runs:
        got = r[("gnn", mesh)][arch]
        np.testing.assert_allclose(got["grad_norm"],
                                   reference[f"{key}/grad_norm"], rtol=RTOL)
        assert_params_close(got["params"], [
            reference[f"{key}/p{i}"] for i in range(len(got["params"]))])
