"""Rank programs of the training-across-ranks tests
(test_torch_dist_train_lm.py, test_torch_dist_train_models.py,
test_torch_dist_checkpoint.py): each runs on every gloo rank that
`test_torch_dist_ranks.run_ranks` spawns (as "_torch_train_ranks:<name>")
and returns numpy arrays, which the tests hold to the one-process port
(`one_process_steps`, run in the parent) and to the JAX package. Every
input is drawn from a seed, whole, in every process; each rank takes its
part. One spawn runs several meshes (`RankContext.remesh`). This file
imports no JAX: the ranks import it."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import tree as TT
from repro_torch.configs import registry
from repro_torch.core import specs as S
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWConfig, adamw_init

AXES = ("data", "model")
MESHES = [(2, 2), (4, 1), (1, 4)]
N_STEPS = 2
BATCH, SEQ = 8, 32
# lr high enough that two steps move every param well past float32's
# rounding; clip_norm under the gradients' norm, so every step clips
OPT = AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10, clip_norm=0.5)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def lm_config(kind: str, fsdp: bool = False, seq_shard: bool = True):
    """The reference's mesh program's config (tests/distributed/
    lm_mesh_prog.py: vocab 250 padded to 256, 6 experts, capacity factor
    8 so nothing drops), in float32; "dense" swaps its experts for a
    SwiGLU FFN, "gqa1" is dense with one KV head (gemma3-1b's, whole on
    "model")."""
    cfg = T.TransformerConfig(
        name=f"mesh-{kind}", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
        d_head=8, d_ff=64, vocab=250, n_experts=6, top_k=2, d_expert_ff=32,
        capacity_factor=8.0, kv_chunk=8, remat=True, dtype=torch.float32,
        fsdp=fsdp, seq_shard=seq_shard)
    if kind == "moe":
        return cfg
    cfg = dataclasses.replace(cfg, n_experts=0, top_k=0, d_expert_ff=0)
    if kind == "gqa1":
        cfg = dataclasses.replace(cfg, n_kv_heads=1, qk_norm=True,
                                  tied_embeddings=True, embed_scale=True,
                                  global_every=2, sliding_window=8,
                                  ce_chunk=16)
    return cfg


def lm_params(cfg, ep: int) -> dict:
    """The whole seeded params (experts padded for `ep`), on the CPU."""
    return T.init_params(torch.Generator().manual_seed(0), cfg, ep=ep)


def lm_batches(cfg, n: int = N_STEPS) -> list[dict]:
    rng = np.random.RandomState(1)
    return [{k: rng.randint(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
             for k in ("tokens", "labels")} for _ in range(n)]


def _torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def one_process_steps(cfg, ep: int, n: int = N_STEPS) -> list[dict]:
    """The one-process step's metrics and whole params after each step."""
    params = lm_params(cfg, ep)
    state = adamw_init(params)
    step = T.make_train_step(cfg, OPT)
    out = []
    for b in lm_batches(cfg, n):
        params, state, m = step(params, state, _torch_batch(b))
        out.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                    "aux": float(m["aux"]),
                    "params": [_np(x) for x in TT.leaves(params)]})
    return out


def rank_rows(b: dict, ranks) -> dict:
    from repro_torch.data.tokens import data_rows

    return _torch_batch(data_rows(b, ranks.axis_index("data"),
                                  ranks.axis_size("data")))


def mesh_steps(ranks, cfg, n: int = N_STEPS) -> dict:
    """The train step across these ranks: metrics, the whole params after
    each step (gathered), and the local shapes of m and v beside those
    `_opt_specs` gives."""
    model = ranks.axis_size("model")
    specs = T.param_specs(cfg, False, model)
    params = T.shard_params(lm_params(cfg, model), ranks, specs)
    state = adamw_init(params, specs, ranks)
    step = T.make_train_step(cfg, OPT, ranks=ranks)
    whole = T.init_params(None, cfg, ep=model, device="meta")
    mv = registry._opt_specs(specs, whole, ranks.axis_size("data"))["m"]
    out = {"steps": [], "mv": [tuple(m.shape) for m in TT.leaves(state["m"])],
           "mv_want": [S.local_shape(x.shape, s, ranks) for x, s in zip(
               TT.leaves(whole), S.spec_leaves(mv, whole))],
           "local": [tuple(p.shape) for p in TT.leaves(params)]}
    for b in lm_batches(cfg, n):
        params, state, m = step(params, state, rank_rows(b, ranks))
        whole = [_np(S.gather(p, sp, ranks)) for p, sp in zip(
            TT.leaves(params), S.spec_leaves(specs, params))]
        out["steps"].append({"loss": float(m["loss"]),
                             "grad_norm": float(m["grad_norm"]),
                             "aux": float(m["aux"]), "params": whole})
    return out


# (kind, fsdp, seq_shard): the cases every mesh runs
LM_CASES = [("dense", False, True), ("moe", False, True), ("dense", True, True),
            ("moe", True, False), ("gqa1", False, True), ("dense", False, False)]


def lm_train_prog(ranks) -> dict:
    """Every LM case on every mesh of 4 ranks."""
    out = {}
    for sizes in MESHES:
        mesh = ranks.remesh(sizes, AXES)
        for kind, fsdp, seq in LM_CASES:
            out[(sizes, kind, fsdp, seq)] = mesh_steps(
                mesh, lm_config(kind, fsdp, seq))
    return out


# -- the replicated pair across ranks ------------------------------------------

def replicated_in_jacobians(fn, x: torch.Tensor, group, sum_grads: bool):
    """The cross-rank Jacobian of `fn`, whose input is the same on every
    rank (a replicated tensor, one variable), in float64, both ways:

      num (x.numel(), this rank's out.numel()): d(this rank's output) /
          d(input element i), central differences with the element moved
          on every rank at once;
      ana (sum over ranks of out.numel(), x.numel()): the input's
          gradient when rank s alone seeds its output element j with 1
          (every rank computes all of it): this rank's own (the pair's
          split hands every rank the whole), or with `sum_grads` the sum
          of every rank's (code whose ranks each hold a part of it).

    Stacked over the ranks along the output axis, num is ana's transpose."""
    import torch.distributed as dist

    from _torch_model_ranks import EPS

    world, rank = dist.get_world_size(group), dist.get_rank(group)
    num = []
    for i in range(x.numel()):
        cols = []
        for sign in (1.0, -1.0):
            xp = x.detach().clone()
            xp.view(-1)[i] += sign * EPS
            cols.append(fn(xp).reshape(-1))
        num.append((cols[0] - cols[1]) / (2 * EPS))
    n_out = [num[0].numel()] * world
    ana = []
    for s, m in enumerate(n_out):
        for j in range(m):
            xg = x.detach().clone().requires_grad_(True)
            y = fn(xg)
            seed = torch.zeros(y.shape, dtype=y.dtype)
            if s == rank:
                seed.view(-1)[j] = 1.0
            y.backward(seed)
            g = xg.grad.reshape(-1).clone()
            if sum_grads:
                dist.all_reduce(g, group=group)
            ana.append(g)
    return _np(torch.stack(num)), _np(torch.stack(ana))


def replicated_inputs(world: int) -> dict:
    rng = np.random.RandomState(4)
    return {"x": rng.randn(world, 2 * world),
            "w": rng.randn(world, world, 2)}


def replicated_prog(ranks) -> dict:
    """split_replicated's cross-rank Jacobian, and the replicated region's
    (this rank's slice through a rank-mixing exchange and gathered back,
    gradients in parts, as the MoE block trains at ep > 1) with every
    rank's gradient summed; the pair's forwards."""
    from repro_torch.core import distributed as D
    from repro_torch.core import specs as S

    axes = tuple(ranks.mesh.axis_names)
    group = ranks.group(axes)
    inp = replicated_inputs(ranks.world_size)
    x = torch.from_numpy(inp["x"])
    w = torch.from_numpy(inp["w"][ranks.rank])

    def region(v):
        part = S.shard(v, (None, axes), ranks)
        return S.gather_dim(D.exchange(part * w, group), group, 1, grad=True)

    return {
        "split": _np(D.split_replicated(x, group, 1)),
        "region": _np(region(x)),
        "split_jac": replicated_in_jacobians(
            lambda v: D.split_replicated(v, group, 1), x, group, False),
        "region_jac": replicated_in_jacobians(region, x, group, True),
    }


def one_rank_prog(ranks) -> dict:
    """At one rank the step across ranks is the one-process step: both
    steps' params and metrics after two steps."""
    out = {}
    for kind in ("dense", "moe"):
        cfg = lm_config(kind)
        runs = []
        for r in (None, ranks):
            params = lm_params(cfg, 1)
            state = adamw_init(params)
            step = T.make_train_step(cfg, OPT, ranks=r)
            for b in lm_batches(cfg):
                params, state, m = step(params, state, _torch_batch(b))
            runs.append({"params": [_np(p) for p in TT.leaves(params)],
                         "metrics": {k: _np(v) for k, v in m.items()}})
        out[kind] = runs
    return out


# -- the GNN and DeepFM train steps across ranks --------------------------------

GNN_TRAIN_CASES = (  # (arch, nodes, edges, edge slots, stream chunks)
    ("meshgraphnet", 64, 500, 512, 0),
    ("graphcast", 256, 2000, 2048, 4),
)
DEEPFM_BATCH = 32


def gnn_case(arch, n, e, e_cap, chunks, sharded: bool):
    """(module, config, params, whole graph) of a GNN case: the reduced
    config (node-sharded with the shuffle when `sharded`), remat on."""
    import _torch_model_ranks as MR
    from repro_torch.configs import registry as TR

    cfg = dataclasses.replace(MR.gnn_config(arch, chunks, True, sharded),
                              remat=True)
    return (TR._gnn_module(arch), cfg, MR.gnn_params(arch, cfg),
            MR.gnn_graph(arch, n, e, e_cap))


def gnn_one_process(case) -> dict:
    from repro_torch.configs import registry as TR
    from repro_torch.data.graphs import to_device

    mod, cfg, params, g = gnn_case(*case, sharded=False)
    step = TR.gnn_train_step(mod, cfg, OPT)
    params, _, m = step(params, adamw_init(params), to_device(g, "cpu"))
    return {"params": [_np(p) for p in TT.leaves(params)],
            "grad_norm": float(m["grad_norm"])}


def deepfm_batch():
    rng = np.random.RandomState(6)
    return {"ids": rng.randint(0, 50, (DEEPFM_BATCH, 6)).astype(np.int32),
            "labels": (rng.rand(DEEPFM_BATCH) < 0.3).astype(np.float32)}


def deepfm_one_process() -> dict:
    import _torch_model_ranks as MR
    from repro_torch.configs import registry as TR

    params = MR.deepfm_params()
    step = TR.deepfm_train_step(MR.deepfm_config(), OPT)
    params, state, m = step(params, adamw_init(params),
                            _torch_batch(deepfm_batch()))
    return {"params": [_np(p) for p in TT.leaves(params)],
            "m": [_np(x) for x in TT.leaves(state["m"])],
            "grad_norm": float(m["grad_norm"])}


def _count_segment_sums():
    from unittest import mock

    from repro_torch.core import segments

    return mock.patch.object(segments.seg_ops, "sorted_segment_sum",
                             wraps=segments.seg_ops.sorted_segment_sum)


def gnn_steps(ranks) -> dict:
    from repro_torch.configs import registry as TR
    from repro_torch.data.graphs import shard_graph

    out = {}
    for case in GNN_TRAIN_CASES:
        mod, cfg, params, g = gnn_case(*case, sharded=True)
        gs = shard_graph(g, ranks, case[4])
        with torch.no_grad(), _count_segment_sums() as fwd:
            mod.apply(params, gs, cfg, ranks=ranks)
        step = TR.gnn_train_step(mod, cfg, OPT, ranks=ranks)
        with _count_segment_sums() as calls:
            params, _, m = step(params, adamw_init(params), gs)
        out[case] = {"params": [_np(p) for p in TT.leaves(params)],
                     "grad_norm": float(m["grad_norm"]),
                     "forward_sums": fwd.call_count,
                     "step_sums": calls.call_count}
    return out


def deepfm_steps(ranks) -> dict:
    """One DeepFM step on this rank's rows (the batch cut over every
    axis): the whole params after it and this rank's m beside its
    `_opt_specs` shape."""
    import _torch_model_ranks as MR
    from repro_torch.configs import registry as TR
    from repro_torch.models.recsys import deepfm as DF

    cfg = MR.deepfm_config()
    specs = DF.param_specs(cfg)
    params = DF.shard_params(MR.deepfm_params(), ranks, cfg)
    state = adamw_init(params, specs, ranks)
    b = deepfm_batch()
    k = DEEPFM_BATCH // ranks.world_size
    mine = {n: torch.from_numpy(v[ranks.rank * k:(ranks.rank + 1) * k])
            for n, v in b.items()}
    step = TR.deepfm_train_step(cfg, OPT, ranks=ranks)
    params, state, m = step(params, state, mine)
    whole = DF.init_params(None, cfg, device="meta")
    mv = TR._opt_specs(specs, whole, ranks.axis_size("data"))["m"]
    return {"params": [_np(S.gather(p, s, ranks)) for p, s in zip(
                TT.leaves(params), S.spec_leaves(specs, params))],
            "m": [_np(S.gather(x, s, ranks)) for x, s in zip(
                TT.leaves(state["m"]), S.spec_leaves(mv, state["m"]))],
            "m_local": [tuple(x.shape) for x in TT.leaves(state["m"])],
            "m_want": [S.local_shape(x.shape, s, ranks) for x, s in zip(
                TT.leaves(whole), S.spec_leaves(mv, whole))],
            "grad_norm": float(m["grad_norm"])}


def models_train_prog(ranks) -> dict:
    out = {}
    for sizes in ((2, 2), (1, 4)):
        mesh = ranks.remesh(sizes, AXES)
        out[sizes] = {"gnn": gnn_steps(mesh), "deepfm": deepfm_steps(mesh)}
    return out


# -- checkpoints across ranks ---------------------------------------------------

CKPT_CFG = ("moe", True, True)  # experts, FSDP, sequence sharding
CKPT_STEP = 3


def ckpt_state(ranks, cfg) -> tuple[dict, dict]:
    """This rank's {"params", "opt"} after one step on `ranks`'s mesh, and
    its spec tree."""
    from repro_torch.optim.adamw import state_specs

    model = ranks.axis_size("model")
    specs = T.param_specs(cfg, False, model)
    params = T.shard_params(lm_params(cfg, model), ranks, specs)
    state = adamw_init(params, specs, ranks)
    step = T.make_train_step(cfg, OPT, ranks=ranks)
    params, state, _ = step(params, state, rank_rows(lm_batches(cfg)[0],
                                                     ranks))
    return ({"params": params, "opt": state},
            {"params": specs, "opt": state_specs(params, specs, ranks)})


def like_state(ranks, cfg) -> tuple[dict, dict]:
    """Zeros of this rank's {"params", "opt"} blocks on `ranks`'s mesh,
    and their spec tree (a restore's `like_tree`)."""
    from repro_torch.optim.adamw import state_specs

    model = ranks.axis_size("model")
    specs = T.param_specs(cfg, False, model)
    params = TT.map(torch.zeros_like, T.shard_params(lm_params(cfg, model),
                                                     ranks, specs))
    return ({"params": params, "opt": adamw_init(params, specs, ranks)},
            {"params": specs, "opt": state_specs(params, specs, ranks)})


def _whole(tree, specs, ranks) -> list:
    return [_np(S.gather(x, s, ranks)) for x, s in zip(
        TT.leaves(tree), S.spec_leaves(specs, tree))]


def _blocks(tree) -> list:
    return [_np(x) for x in TT.leaves(tree)]


def ckpt_prog(ranks, root: str, from_one: str, from_ref: str) -> dict:
    """Write a checkpoint on (data 2, model 2) (every rank calls save;
    rank 0 writes), restore it onto (4, 1); restore the one-process and
    the reference's checkpoints (written at world 1 under `from_one` and
    `from_ref`, step CKPT_STEP) onto (2, 2)."""
    from repro_torch.checkpoint.manager import CheckpointManager

    cfg = lm_config(*CKPT_CFG)
    mesh = ranks.remesh((2, 2), AXES)
    tree, specs = ckpt_state(mesh, cfg)
    mgr = CheckpointManager(root, async_write=True)
    mgr.save(CKPT_STEP, tree, extra_meta={"pipeline": {"step": 7}},
             ranks=mesh, specs=specs)
    mgr.wait()
    out = {"written": _whole(tree, specs, mesh),
           "listed": mgr.all_steps()}
    other = ranks.remesh((4, 1), AXES)
    like, like_specs = like_state(other, cfg)
    got = mgr.restore(CKPT_STEP, like, ranks=other, specs=like_specs)
    out["onto_4x1"] = _whole(got, like_specs, other)
    out["onto_4x1_blocks"] = _blocks(got)
    like, like_specs = like_state(mesh, cfg)
    for name, path in (("from_one", from_one), ("from_ref", from_ref)):
        got = CheckpointManager(path).restore(CKPT_STEP, like, ranks=mesh,
                                              specs=like_specs)
        out[name] = _blocks(got)
        out[name + "_want"] = [
            _np(S.shard(torch.from_numpy(np.asarray(w)), s, mesh))
            for w, s in zip(_one_state_leaves(cfg),
                            S.spec_leaves(like_specs, like))]
    return out


def one_state(cfg) -> dict:
    """The whole {"params", "opt"} after the one-process step (the state a
    world-1 checkpoint holds)."""
    params = lm_params(cfg, 2)
    state = adamw_init(params)
    params, state, _ = T.make_train_step(cfg, OPT)(
        params, state, _torch_batch(lm_batches(cfg)[0]))
    return {"params": params, "opt": state}


def _one_state_leaves(cfg) -> list:
    return [_np(x) for x in TT.leaves(one_state(cfg))]


def trainer_prog(ranks, straight: str, resumed: str) -> dict:
    """The Trainer across (data 2, model 2): a straight run of 6 steps,
    and one whose first attempt dies after step 3 under
    `run_with_restarts` (checkpoints every 2 steps, async), from which it
    resumes at step 2 on every rank."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.train.trainer import (Trainer, TrainSettings,
                                           run_with_restarts)

    cfg = lm_config("moe")
    mesh = ranks.remesh((2, 2), AXES)
    specs = T.param_specs(cfg, False, 2)

    def make(path, fail_at=-1):
        params = T.shard_params(lm_params(cfg, 2), mesh, specs)
        return Trainer(
            T.make_train_step(cfg, OPT, ranks=mesh), params,
            TokenPipeline(vocab=cfg.vocab, batch=BATCH, seq=SEQ), path,
            TrainSettings(total_steps=6, ckpt_every=2, log_every=0,
                          fail_at_step=fail_at, async_ckpt=True),
            to_device=lambda b: {k: torch.from_numpy(v)
                                 for k, v in b.items()},
            ranks=mesh, specs=specs)

    a = make(straight)
    a.run()
    calls = {"n": 0}

    def factory():
        calls["n"] += 1
        return make(resumed, 3 if calls["n"] == 1 else -1)

    b = run_with_restarts(factory)
    return {"straight": [h["loss"] for h in a.history],
            "resumed": [h["loss"] for h in b.history],
            "attempts": calls["n"],
            "same_params": all(torch.equal(x, y) for x, y in zip(
                TT.leaves(a.params), TT.leaves(b.params))),
            "same_opt": all(torch.equal(x, y) for x, y in zip(
                TT.leaves(a.opt_state), TT.leaves(b.opt_state))),
            "cursor": b.pipeline.step}
