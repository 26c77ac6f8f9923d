"""The port's training loop and its parts on the CPU: the token pipeline
and prefetcher (`repro_torch.data.tokens`) against the reference's; the
checkpoint manager (`repro_torch.checkpoint.manager`) on its own and
across packages (a checkpoint either one writes restores in the other);
the Trainer (`repro_torch.train.trainer`): crash and restart against the
uninterrupted run, the pipeline's position, the non-finite skip; and
`python -m repro_torch.launch.train --device cpu`.

Tolerances: none. Token batches, restored leaves and the restarted run's
params and moments are compared bit for bit (bf16 as its uint16 bits).
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.data.tokens import Prefetcher as RefPrefetcher
from repro.data.tokens import TokenPipeline as RefPipeline
from repro_torch import tree as TT
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.tokens import Prefetcher, TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.trainer import (SimulatedFailure, Trainer,
                                       TrainSettings, host_metrics,
                                       run_with_restarts)


def _bits(x) -> np.ndarray:
    """A leaf's raw bits (torch or numpy / jax; bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_bit_equal(got_tree, want_leaves):
    got = TT.leaves(got_tree)
    assert len(got) == len(want_leaves)
    for path, g, w in zip(TT.paths(got_tree), got, want_leaves):
        a, b = _bits(g), _bits(w)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path


# ---------------------------------------------------------------------------
# Token pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_token_batches_are_the_reference_bit_for_bit(seed):
    mine = TokenPipeline(vocab=300, batch=4, seq=16, seed=seed)
    ref = RefPipeline(vocab=300, batch=4, seq=16, seed=seed)
    for _ in range(5):
        a, b = next(mine), next(ref)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    assert mine.state_dict() == ref.state_dict() == {"seed": seed, "step": 5}
    np.testing.assert_array_equal(mine.batch_at(11)["tokens"],
                                  ref.batch_at(11)["tokens"])
    mine.load_state_dict({"seed": seed, "step": 2})
    np.testing.assert_array_equal(next(mine)["labels"],
                                  ref.batch_at(2)["labels"])


def test_prefetcher_yields_the_reference_stream():
    mine = Prefetcher(TokenPipeline(vocab=100, batch=2, seq=8, seed=3))
    ref = RefPrefetcher(RefPipeline(vocab=100, batch=2, seq=8, seed=3))
    try:
        for _ in range(6):
            np.testing.assert_array_equal(next(mine)["tokens"],
                                          next(ref)["tokens"])
    finally:
        mine.close()
        ref.close()
    assert not mine.t.is_alive()


# ---------------------------------------------------------------------------
# Checkpoint manager
# ---------------------------------------------------------------------------

def _tree():
    return {"b": [torch.tensor(3, dtype=torch.int32)],
            "a": torch.arange(6.0).reshape(2, 3),
            "h": torch.linspace(-2, 2, 7).to(torch.bfloat16)}


def test_manager_roundtrip_keepk_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_k=2, async_write=True)
    tree = _tree()
    for step in (1, 2, 3, 4):
        mgr.save(step, tree, extra_meta={"pipeline": {"step": step}})
    mgr.wait()
    assert mgr.all_steps() == [3, 4]  # keep_k pruned
    assert mgr.latest_step() == 4
    got = mgr.restore(4, tree)
    _assert_bit_equal(got, TT.leaves(tree))
    assert got["h"].dtype == torch.bfloat16 and list(got) == list(tree)
    assert mgr.meta(4)["pipeline"]["step"] == 4


def test_manager_snapshots_before_save_returns(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    tree = {"x": torch.ones(1000)}
    mgr.save(1, tree)
    tree["x"].mul_(5)  # the caller reuses its tensor at once
    mgr.wait()
    assert torch.equal(mgr.restore(1, {"x": torch.zeros(1000)})["x"],
                       torch.ones(1000))


def test_manager_atomic_tmp_never_visible(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_k=5)
    os.makedirs(tmp_path / "step_00000009.tmp")  # a crashed writer's
    mgr.save(7, {"x": torch.ones(3)})
    names = os.listdir(tmp_path)
    assert "step_00000007" in names
    assert mgr.all_steps() == [7]  # the tmp dir is not a step
    assert sorted(os.listdir(tmp_path / "step_00000007")) == \
        ["arrays.npz", "meta.json"]


def test_manager_async_write_failure_raises_on_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), async_write=True)

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken)
    mgr.save(1, {"x": torch.ones(3)})
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        mgr.wait()
    assert mgr.all_steps() == []


def _mixed_numpy_tree(rng):
    """A train-state-like tree: bf16 params, float32 moments, int32 step."""
    def bf16(shape):
        return rng.standard_normal(shape).astype(ml_dtypes.bfloat16)

    def f32(shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"params": {"w": bf16((4, 5)), "layers": [bf16((3,)), bf16((2, 2))]},
            "opt": {"m": {"w": f32((4, 5)), "layers": [f32((3,)), f32((2, 2))]},
                    "v": {"w": f32((4, 5)), "layers": [f32((3,)), f32((2, 2))]},
                    "step": np.int32(12)}}


def _torch_like(tree):
    def leaf(a):
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.zeros(a.shape, dtype=torch.bfloat16)
        return torch.zeros(a.shape, dtype=torch.from_numpy(a.copy()).dtype)
    return jax.tree.map(leaf, tree)


def test_a_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _mixed_numpy_tree(np.random.default_rng(0))
    RefManager(str(tmp_path)).save(12, jax.tree.map(jnp.asarray, tree),
                                   extra_meta={"pipeline": {"step": 12}})
    mgr = CheckpointManager(str(tmp_path))
    got = mgr.restore(12, _torch_like(tree))
    _assert_bit_equal(got, jax.tree.leaves(tree))
    assert got["opt"]["step"].dtype == torch.int32
    assert mgr.meta(12)["pipeline"] == {"step": 12}


def test_a_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _mixed_numpy_tree(np.random.default_rng(1))
    like = _torch_like(tree)
    mine = TT.unflatten(like, [
        torch.from_numpy(np.asarray(a).view(np.uint16).copy()).view(
            torch.bfloat16) if np.asarray(a).dtype == ml_dtypes.bfloat16
        else torch.from_numpy(np.array(a, copy=True))
        for a in jax.tree.leaves(tree)])
    CheckpointManager(str(tmp_path)).save(5, mine,
                                          extra_meta={"pipeline": {"step": 5}})
    ref = RefManager(str(tmp_path))
    got = ref.restore(5, jax.tree.map(jnp.asarray, tree))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        assert np.array_equal(_bits(g), _bits(w))
    assert ref.meta(5)["pipeline"] == {"step": 5}
    meta = json.loads((tmp_path / "step_00000005" / "meta.json").read_text())
    assert meta["step"] == 5


def test_a_reference_train_state_restores_into_the_port_model(tmp_path):
    """The reference's LM params and AdamW state, saved by its manager,
    restored into the port's own (params, opt) tree of the same config."""
    from repro.launch.train import reduced_lm as ref_reduced_lm
    from repro.models import transformer as RT
    from repro.optim.adamw import adamw_init as ref_adamw_init
    from repro_torch.configs.registry import ARCHS

    import importlib

    rcfg = ref_reduced_lm(importlib.import_module(
        "repro.configs.olmoe_1b_7b").CONFIG)
    cfg = launch_train.reduced_lm(importlib.import_module(
        ARCHS["olmoe-1b-7b"]).CONFIG)
    rparams = RT.init_params(jax.random.PRNGKey(0), rcfg)
    rtree = {"params": rparams, "opt": ref_adamw_init(rparams)}
    RefManager(str(tmp_path)).save(3, rtree)
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    got = CheckpointManager(str(tmp_path)).restore(
        3, {"params": params, "opt": adamw_init(params)})
    _assert_bit_equal(got, jax.tree.leaves(rtree))
    want = T.params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, "cpu")
    _assert_bit_equal(got["params"], TT.leaves(want))


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

CFG = T.TransformerConfig(
    name="t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_head=16,
    d_ff=64, vocab=128, kv_chunk=8, remat=False)


def _make_trainer(tmp_path, fail_at=-1, total=12, async_ckpt=False):
    params = T.init_params(torch.Generator().manual_seed(0), CFG)
    step = T.make_train_step(CFG, AdamWConfig(lr=1e-3))
    pipe = TokenPipeline(vocab=CFG.vocab, batch=4, seq=16)
    return Trainer(step, params, pipe, str(tmp_path),
                   TrainSettings(total_steps=total, ckpt_every=4,
                                 log_every=0, fail_at_step=fail_at,
                                 async_ckpt=async_ckpt),
                   to_device=lambda b: {k: torch.from_numpy(v)
                                        for k, v in b.items()})


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_crash_restart_matches_uninterrupted(tmp_path, async_ckpt):
    straight = _make_trainer(tmp_path / "a", async_ckpt=async_ckpt)
    straight.run()
    calls = {"n": 0}

    def factory():  # one-off preemption: only the first attempt dies
        calls["n"] += 1
        return _make_trainer(tmp_path / "b", async_ckpt=async_ckpt,
                             fail_at=6 if calls["n"] == 1 else -1)

    resumed = run_with_restarts(factory)
    assert calls["n"] == 2
    assert resumed.step == straight.step == 12
    _assert_bit_equal(resumed.params, TT.leaves(straight.params))
    _assert_bit_equal(resumed.opt_state, TT.leaves(straight.opt_state))
    # the resumed run repeats steps 5-6 from step 4's checkpoint, and its
    # losses from there on are the straight run's
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in straight.history[4:]]


def test_restart_resumes_pipeline_position(tmp_path):
    tr = _make_trainer(tmp_path, fail_at=6, total=8)
    with pytest.raises(SimulatedFailure):
        tr.run()
    tr2 = _make_trainer(tmp_path, total=8)
    assert tr2.resume_if_possible()
    assert tr2.step == 4  # last checkpoint
    assert tr2.pipeline.step == 4  # data stream cursor restored
    assert int(tr2.opt_state["step"]) == 4


def test_nonfinite_step_skipped(tmp_path):
    tr = _make_trainer(tmp_path, total=1)
    tr.train_step = lambda p, s, b: (p, s, {"loss": torch.tensor(float("nan"))})
    before = TT.leaves(tr.params)[0].clone()
    tr.run()
    assert torch.equal(before, TT.leaves(tr.params)[0])
    assert tr.history[-1].get("skipped") == 1.0


def test_host_metrics_read_once_equal_float_of_each():
    m = {"loss": torch.tensor(2.5), "lr": torch.tensor(3e-4),
         "step": torch.tensor(7, dtype=torch.int32), "n": 4}
    got = host_metrics(m)
    assert list(got) == list(m)
    assert got == {k: float(v) for k, v in m.items()}


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------

def test_launch_train_on_the_cpu_runs_and_resumes(tmp_path, capsys):
    argv = ["--device", "cpu", "--arch", "gemma3-1b", "--steps", "4",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    hist = launch_train.main(argv)
    assert [h["step"] for h in hist] == [1, 2, 3, 4]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert "final loss" in capsys.readouterr().out
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4]
    # a rerun with more steps resumes from step 4
    more = launch_train.main(argv[:5] + ["6"] + argv[6:])
    assert [h["step"] for h in more] == [5, 6]


def test_launch_train_needs_a_card_unless_asked_for_the_cpu(monkeypatch,
                                                            tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
