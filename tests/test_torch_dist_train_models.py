"""The GNN and DeepFM train steps across ranks (4 gloo ranks on the CPU,
meshes (data 2, model 2) and (1, 4)), held to the one-process port's
step.

- MeshGraphNet and GraphCast (streamed in 4 chunks), node-sharded with
  the shuffle and remat (reduced configs, float32): after one step the
  params within 1e-5 (relative L2 of the tree), each leaf within 1e-3 of
  its norm (AdamW's first step: see test_torch_dist_train_lm.py),
  grad_norm within 1e-5 relative; every
  rank takes the same step; a step runs the sorted segment sum (the
  segment_reduce kernel on the card) once per aggregation in the forward
  and once more in the remat, on every rank;
- DeepFM (the small config of test_torch_dist_autograd.py), the batch cut
  over every axis: the updated table, fm_w and the dense weights within
  1e-6 of the one-process step's (elementwise), grad_norm within 1e-6
  relative, m within 1e-6, and m and v ZeRO-1 slices by `_opt_specs`.
"""
import numpy as np
import pytest

import _torch_train_ranks as TRR
from test_torch_dist_ranks import run_ranks
from test_torch_dist_train_lm import assert_params_close

MESHES = [(2, 2), (1, 4)]
RTOL = 1e-5
DEEPFM_TOL = dict(rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("train_models"), 4,
                     "_torch_train_ranks:models_train_prog", axis_sizes=(4,),
                     axis_names=("world",), timeout=300)


@pytest.fixture(scope="module")
def gnn_one_process():
    return {case: TRR.gnn_one_process(case) for case in TRR.GNN_TRAIN_CASES}


@pytest.mark.parametrize("case", TRR.GNN_TRAIN_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_gnn_train_step_across_ranks_equals_one_process(runs, gnn_one_process,
                                                        mesh, case):
    want = gnn_one_process[case]
    first = runs[0][mesh]["gnn"][case]
    for rank in runs:
        got = rank[mesh]["gnn"][case]
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=RTOL)
        assert_params_close(got["params"], want["params"])
        for a, c in zip(got["params"], first["params"]):
            np.testing.assert_array_equal(a, c)  # one step on every rank


@pytest.mark.parametrize("case", TRR.GNN_TRAIN_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_gnn_step_runs_segment_sum_per_aggregation_and_remat(runs, mesh,
                                                             case):
    for rank in runs:
        got = rank[mesh]["gnn"][case]
        assert got["forward_sums"] > 0
        assert got["step_sums"] == 2 * got["forward_sums"]


@pytest.fixture(scope="module")
def deepfm_one_process():
    return TRR.deepfm_one_process()


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_deepfm_train_step_across_ranks_equals_one_process(
        runs, deepfm_one_process, mesh):
    want = deepfm_one_process
    for rank in runs:
        got = rank[mesh]["deepfm"]
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-6)
        for a, b in zip(got["params"], want["params"]):
            np.testing.assert_allclose(a, b, **DEEPFM_TOL)
        for a, b in zip(got["m"], want["m"]):
            np.testing.assert_allclose(a, b, **DEEPFM_TOL)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_deepfm_m_and_v_are_zero1_slices(runs, mesh):
    for rank in runs:
        got = rank[mesh]["deepfm"]
        assert got["m_local"] == got["m_want"]
    if mesh[0] > 1:  # the table's m is cut over "data" too
        table = runs[0][mesh]["deepfm"]["m_local"][-1]
        assert table == (300 // mesh[1], 4 // mesh[0])
