"""Meshes with a "pod" axis (8 gloo ranks on the CPU, mesh (pod 2, data 2,
model 2)): `RankContext.group` over a subset of the axes, and the LM
train step with the multi-pod specs.

- `group(("pod", "data"))` (and ("pod", "model"), ("data", "model"))
  holds this rank's line over those axes in the reference's flat
  row-major order, and this rank's place in it is `axis_index`;
- the reduced LM train step (test_torch_dist_train_lm.py's configs:
  dense, MoE at ep = 2, dense with FSDP; float32), its batch cut over
  ("pod", "data") (`dp_axes(True)`), ZeRO-1 over "data": the loss and
  grad_norm within 1e-5 relative of the one-process step after each of
  two steps, the params within 1e-5 (relative L2 of the tree) and each
  leaf within 1e-3 of its norm, as that file holds its meshes;
- the first step's loss and grad_norm within 1e-5 relative of the
  reference's train step with the multi-pod specs on a (2, 2, 2) mesh of
  8 host devices, its inputs placed as its train cells place them
  (tests/distributed/cells_mesh_prog.py `pod`, in a subprocess). Both
  run in float32 on the same weights and batch; the reference and the
  one-process port agree to 8.4e-8 here, far inside the 2e-3 that
  lm_train_mesh_prog.py allows.
"""
import itertools

import jax  # noqa: F401  (test files import both frameworks)
import numpy as np
import pytest

import _torch_cell_ranks as CR
import _torch_train_ranks as TRR
from test_torch_dist_ranks import run_ranks
from test_torch_dist_train_lm import assert_params_close

RTOL = 1e-5
SIZES = (2, 2, 2)
CASE_IDS = ["-".join(map(str, c)) for c in CR.POD_CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("pod"), 8,
                     "_torch_cell_ranks:pod_prog", axis_sizes=SIZES,
                     axis_names=CR.POD_AXES, timeout=400)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return CR.reference_cells("pod", tmp_path_factory.mktemp("pod_ref"))


@pytest.mark.parametrize("axes", [("pod", "data"), ("pod", "model"),
                                  ("data", "model")], ids="-".join)
def test_group_over_axes_is_the_flat_line(runs, axes):
    coords = list(itertools.product(*(range(s) for s in SIZES)))
    for rank, got in enumerate(runs):
        me = coords[rank]
        keep = [CR.POD_AXES.index(a) for a in axes]
        line = [r for r, c in enumerate(coords)
                if all(c[i] == me[i] for i in range(3) if i not in keep)]
        g = got["groups"][axes]
        assert g["ranks"] == line
        index = 0
        for i in keep:
            index = index * SIZES[i] + me[i]
        assert g["rank_in_group"] == g["axis_index"] == index


@pytest.mark.parametrize("case", CR.POD_CASES, ids=CASE_IDS)
def test_multi_pod_train_step_equals_one_process(runs, case):
    want = TRR.one_process_steps(TRR.lm_config(*case), SIZES[2])
    for rank in runs:
        for g, w in zip(rank["steps"][case], want):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       rtol=RTOL)
            assert_params_close(g["params"], w["params"])


@pytest.mark.parametrize("case", CR.POD_CASES, ids=CASE_IDS)
def test_multi_pod_train_step_is_the_reference_mesh_programs(runs, reference,
                                                             case):
    key = "pod/" + "-".join(map(str, case))
    for rank in runs:
        got = rank["steps"][case][0]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[k], reference[f"{key}/{k}"],
                                       rtol=RTOL)
