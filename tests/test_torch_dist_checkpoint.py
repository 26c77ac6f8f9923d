"""Checkpoints, the Trainer and the launcher across ranks (gloo on the
CPU).

- elastic restore, leaves bit-equal: a checkpoint written by 4 ranks on
  (data 2, model 2) (params FSDP- and tensor-cut, m and v ZeRO-1 slices,
  gathered whole and written by rank 0) restores in one process, onto
  (4, 1) and in the reference's CheckpointManager; one written by one
  process, and one the reference wrote, restore onto (2, 2) as each
  rank's blocks;
- the Trainer across (2, 2): a run whose first attempt dies after step 3
  resumes on every rank from step 2's checkpoint under
  `run_with_restarts` and ends with the straight run's params, opt state
  and losses, bit for bit, the pipeline's cursor restored;
- `launch.train` under `torch.distributed.run` on 2 gloo CPU ranks
  trains, writes its checkpoints from rank 0, and a rerun resumes from
  them.
"""
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro_torch import tree as TT
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.optim.adamw import adamw_init

import _torch_train_ranks as TRR
from test_torch_dist_ranks import run_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _numpy_tree(tree):
    return jax.tree.map(lambda x: x.numpy(), tree)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    cfg = TRR.lm_config(*TRR.CKPT_CFG)
    one = TRR.one_state(cfg)
    CheckpointManager(str(root / "one")).save(TRR.CKPT_STEP, one)
    RefManager(str(root / "ref")).save(
        TRR.CKPT_STEP, jax.tree.map(jnp.asarray, _numpy_tree(one)))
    runs = run_ranks(root, 4, "_torch_train_ranks:ckpt_prog",
                     str(root / "ranks"), str(root / "one"),
                     str(root / "ref"), axis_sizes=(4,),
                     axis_names=("world",))
    return root, runs


def _whole_like(cfg):
    params = TT.map(torch.zeros_like, TRR.lm_params(cfg, 2))
    return {"params": params, "opt": adamw_init(params)}


def test_every_rank_wrote_one_checkpoint_the_same(ckpt):
    root, runs = ckpt
    for r in runs:
        assert r["listed"] == [TRR.CKPT_STEP]
        for a, b in zip(r["written"], runs[0]["written"]):
            np.testing.assert_array_equal(a, b)


def test_a_ranks_checkpoint_restores_in_one_process(ckpt):
    root, runs = ckpt
    cfg = TRR.lm_config(*TRR.CKPT_CFG)
    mgr = CheckpointManager(str(root / "ranks"))
    got = mgr.restore(TRR.CKPT_STEP, _whole_like(cfg))
    leaves = TT.leaves(got)
    assert len(leaves) == len(runs[0]["written"])
    for g, w in zip(leaves, runs[0]["written"]):
        np.testing.assert_array_equal(g.numpy(), w)
    assert mgr.meta(TRR.CKPT_STEP)["pipeline"] == {"step": 7}


def test_a_ranks_checkpoint_restores_onto_another_mesh(ckpt):
    _, runs = ckpt
    for r in runs:
        for g, w in zip(r["onto_4x1"], runs[0]["written"]):
            np.testing.assert_array_equal(g, w)
    # (4, 1) cuts m and v over 4 data ranks, where (2, 2) cut them over 2
    assert any(a.shape != b.shape for a, b in zip(
        runs[0]["onto_4x1_blocks"], runs[0]["from_one"]))


def test_a_ranks_checkpoint_restores_in_the_reference(ckpt):
    root, runs = ckpt
    cfg = TRR.lm_config(*TRR.CKPT_CFG)
    like = jax.tree.map(jnp.asarray, _numpy_tree(_whole_like(cfg)))
    got = RefManager(str(root / "ranks")).restore(TRR.CKPT_STEP, like)
    for g, w in zip(jax.tree.leaves(got), runs[0]["written"]):
        assert np.asarray(g).dtype != ml_dtypes.bfloat16
        np.testing.assert_array_equal(np.asarray(g), w)


@pytest.mark.parametrize("source", ["from_one", "from_ref"])
def test_a_whole_checkpoint_restores_as_each_ranks_blocks(ckpt, source):
    _, runs = ckpt
    for r in runs:
        assert len(r[source]) == len(r[source + "_want"])
        for g, w in zip(r[source], r[source + "_want"]):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_trainer_across_ranks_restarts_as_it_ran(tmp_path):
    runs = run_ranks(tmp_path, 4, "_torch_train_ranks:trainer_prog",
                     str(tmp_path / "a"), str(tmp_path / "b"),
                     axis_sizes=(4,), axis_names=("world",))
    for r in runs:
        assert r["attempts"] == 2
        assert r["same_params"] and r["same_opt"]
        assert r["resumed"] == r["straight"][2:]
        assert r["cursor"] == 6
        assert r["straight"] == runs[0]["straight"]
    assert CheckpointManager(str(tmp_path / "b")).all_steps() == [2, 4, 6]


def _launch(args: list[str], cwd) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("WORLD_SIZE", None)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--device", "cpu", *args], env=env, cwd=cwd, capture_output=True,
        text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_launch_train_under_the_launcher_trains_and_resumes(tmp_path):
    args = ["--steps", "4", "--batch", "4", "--seq", "16", "--ckpt-every",
            "2", "--ckpt-dir", str(tmp_path / "ck"), "--mesh",
            "data=2,model=1"]
    out = _launch(args, tmp_path)
    assert "training over 2 ranks, mesh (data=2, model=1), backend gloo" \
        in out
    assert re.search(r"final loss: \d+\.\d+ \(step 4\)", out)
    assert out.count("final loss") == 1  # rank 0 prints
    assert CheckpointManager(str(tmp_path / "ck")).all_steps() == [2, 4]
    more = _launch(["--steps", "6"] + args[2:-2] + ["--mesh",
                                                   "data=1,model=2"],
                   tmp_path)
    assert re.search(r"final loss: \d+\.\d+ \(step 6\)", more)
    assert CheckpointManager(str(tmp_path / "ck")).all_steps() == [2, 4, 6]
