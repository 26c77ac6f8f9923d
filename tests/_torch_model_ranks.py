"""Rank programs of the model exchanges' tests (test_torch_dist_autograd.py,
test_torch_dist_moe.py, test_torch_dist_gnn.py): each runs on every gloo
rank that `test_torch_dist_ranks.run_ranks` spawns (as
"_torch_model_ranks:<name>") and returns numpy arrays, which the test
holds to the one-process port and to the JAX package. Every input is
drawn from a seed, whole, in every process, and each rank takes its own
part of it, so the parent redraws the same whole inputs. This file
imports no JAX: the ranks import it."""
from __future__ import annotations

import dataclasses
import importlib
from unittest import mock

import numpy as np
import torch

from repro_torch import tree as TT
from repro_torch.core import distributed as D

EPS = 1e-6  # central differences in float64


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


# -- the exchanges ------------------------------------------------------------


def cross_jacobians(fn, x: torch.Tensor, n_in: list[int], n_out: list[int],
                    rank: int):
    """The cross-rank Jacobian of `fn` (this rank's input -> its output,
    the same collectives on every rank), in float64, both ways:

      num (sum(n_in), n_out[rank]): d(this rank's output) / d(rank r's
          input element i), central differences with only rank r's
          element moved;
      ana (sum(n_out), n_in[rank]): the gradient of this rank's input
          when rank s alone seeds output element j with 1 (the backward).

    Stacked over the ranks, both are the whole Jacobian."""
    num = []
    for r, n in enumerate(n_in):
        for i in range(n):
            cols = []
            for sign in (1.0, -1.0):
                xp = x.detach().clone()
                if r == rank:
                    xp.view(-1)[i] += sign * EPS
                cols.append(fn(xp).reshape(-1))
            num.append((cols[0] - cols[1]) / (2 * EPS))
    ana = []
    for s, m in enumerate(n_out):
        for j in range(m):
            xg = x.detach().clone().requires_grad_(True)
            y = fn(xg)
            seed = torch.zeros_like(y)
            if s == rank:
                seed.view(-1)[j] = 1.0
            y.backward(seed)
            ana.append(xg.grad.reshape(-1))
    return _np(torch.stack(num)), _np(torch.stack(ana))


def replicated_out_jacobians(fn, x: torch.Tensor, world: int, rank: int):
    """The cross-rank Jacobian of `fn`, whose output is the same on every
    rank (a replicated tensor, one variable), in float64, both ways:

      num (world * x.numel(), out.numel()): d(the output) / d(rank r's
          input element i), central differences with only rank r's
          element moved (every rank computes all of it);
      ana (out.numel(), x.numel()): this rank's input gradient when
          every rank seeds output element j with 1 (the loss downstream
          the same on every rank).

    Stacked over the ranks along the input axis, ana is num's transpose."""
    num = []
    for r in range(world):
        for i in range(x.numel()):
            cols = []
            for sign in (1.0, -1.0):
                xp = x.detach().clone()
                if r == rank:
                    xp.view(-1)[i] += sign * EPS
                cols.append(fn(xp).reshape(-1))
            num.append((cols[0] - cols[1]) / (2 * EPS))
    ana = []
    for j in range(num[0].numel()):
        xg = x.detach().clone().requires_grad_(True)
        y = fn(xg)
        seed = torch.zeros(y.shape, dtype=y.dtype)
        seed.view(-1)[j] = 1.0
        y.backward(seed)
        ana.append(xg.grad.reshape(-1))
    return _np(torch.stack(num)), _np(torch.stack(ana))


def exchange_inputs(world: int, seed: int) -> dict:
    """The whole inputs of exchange_prog, the same in every process."""
    rng = np.random.RandomState(seed)
    splits = rng.randint(0, 4, (world, world))  # [s, d]: rows s sends d
    return {
        "even": rng.randn(world, world * 3, 2),
        "splits": splits,
        "uneven": [rng.randn(int(splits[s].sum()), 2) for s in range(world)],
        "weights": rng.randn(world, world * world * 3, 2),
        "small": rng.randn(world, world),
        "rows": rng.randn(world, 3, 4),
    }


def exchange_prog(ranks, seed: int) -> dict:
    """core.distributed's differentiable collectives over the world group
    (every mesh axis): forwards, the all-gather's backward against the
    reduce-scatter of its gradient, and the cross-rank Jacobians in
    float64 (the replicated gather's with its output's gradient the same
    on every rank)."""
    world, r = ranks.world_size, ranks.rank
    group = ranks.group(tuple(ranks.mesh.axis_names))
    inp = exchange_inputs(world, seed)
    splits = inp["splits"]
    ins, outs = splits[r].tolist(), splits[:, r].tolist()
    t = {k: torch.from_numpy(inp[k][r]) for k in ("even", "small", "rows")}
    t["uneven"] = torch.from_numpy(inp["uneven"][r])
    out = {
        "even": _np(D.exchange(t["even"], group)),
        "uneven": _np(D.exchange(t["uneven"], group, ins, outs)),
        "bool": _np(D.exchange(t["even"] > 0, group)),
    }
    x = t["even"].clone().requires_grad_(True)
    y = D.all_gather_rows(x, group)
    (y * torch.from_numpy(inp["weights"][r])).sum().backward()
    out["gather_grad"] = _np(x.grad)
    out["replicated"] = _np(D.gather_replicated(t["rows"], group, dim=1))
    out["replicated_jacobian"] = replicated_out_jacobians(
        lambda v: D.gather_replicated(v, group, dim=1), t["rows"], world, r)
    n_even = [world * 3 * 2] * world
    n_un = [int(splits[s].sum()) * 2 for s in range(world)]
    n_un_out = [int(splits[:, s].sum()) * 2 for s in range(world)]
    small = [world] * world
    out["jacobians"] = {
        "exchange": cross_jacobians(lambda v: D.exchange(v, group),
                                    t["even"], n_even, n_even, r),
        "exchange_uneven": cross_jacobians(
            lambda v: D.exchange(v, group, ins, outs), t["uneven"], n_un,
            n_un_out, r),
        "all_gather_rows": cross_jacobians(
            lambda v: D.all_gather_rows(v, group), t["small"], small,
            [world * world] * world, r),
        "reduce_scatter_rows": cross_jacobians(
            lambda v: D.reduce_scatter_rows(v, group), t["small"], small,
            [1] * world, r),
        "all_reduce_sum": cross_jacobians(
            lambda v: D.all_reduce_sum(v, group), t["small"], small, small,
            r),
    }
    return out


# -- the sharded DeepFM lookup ------------------------------------------------


def lookup_inputs(seed: int) -> dict:
    """The whole inputs of lookup_prog: a 48 x 5 table, a uniform id
    stream and a skewed one (every id owned by the first table rank, 1,024
    ids: past the reference's capacity, whose floor is 64),
    the weights of a loss over the rows, a small DeepFM config's batch and
    retrieval candidates. The DeepFM weights are the port's seeded init."""
    rng = np.random.RandomState(seed)
    return {
        "table": rng.randn(48, 5).astype(np.float32),
        "ids": rng.randint(0, 48, 128).astype(np.int32),
        "skewed": rng.randint(0, 12, 1024).astype(np.int32),
        "weights": rng.randn(128, 5).astype(np.float32),
        "batch": rng.randint(0, 50, (32, 6)).astype(np.int32),
        "user": rng.randint(0, 50, (1, 6)).astype(np.int32),
        "cand": rng.randint(0, 50, (64, 3)).astype(np.int32),
    }


def deepfm_config():
    from repro_torch.models.recsys import deepfm as DF

    return DF.DeepFMConfig(n_sparse=6, embed_dim=4, mlp_dims=(16, 16),
                           rows_per_field=50)


def deepfm_params(seed: int = 3):
    from repro_torch.models.recsys import deepfm as DF

    return DF.init_params(torch.Generator().manual_seed(seed),
                          deepfm_config())


def lookup_prog(ranks, seed: int) -> dict:
    """The row-sharded lookup over "model" (the table's rows), each rank
    with its slice of every id stream (sharded over every axis jointly):
    rows, the table's gradient, and DeepFM's forward and retrieval scores
    through it."""
    from repro_torch.models.recsys import deepfm as DF

    world, r = ranks.world_size, ranks.rank
    inp = lookup_inputs(seed)
    lookup = DF.make_sharded_lookup(ranks)
    model, m = ranks.axis_size("model"), ranks.axis_index("model")
    rows = 48 // model
    shard = torch.from_numpy(inp["table"][m * rows:(m + 1) * rows])

    def mine(a):
        k = a.shape[0] // world
        return torch.from_numpy(a[r * k:(r + 1) * k])

    out = {"rows": _np(lookup((shard,), mine(inp["ids"]))[0]),
           "skewed": _np(lookup((shard,), mine(inp["skewed"]))[0])}
    live = shard.clone().requires_grad_(True)
    (lookup((live,), mine(inp["ids"]))[0]
     * mine(inp["weights"])).sum().backward()
    out["table_grad"] = _np(live.grad)
    cfg = deepfm_config()
    params = DF.shard_params(deepfm_params(), ranks, cfg)
    with torch.no_grad(), mock.patch.object(
            DF.D, "exchange", wraps=DF.D.exchange) as ex:
        out["logits"] = _np(DF.forward(params, mine(inp["batch"]), cfg,
                                       lookup))
    # the width of each exchange's rows
    out["forward_exchanges"] = [c.args[0][0].numel() if c.args[0].dim() > 1
                                else 1 for c in ex.call_args_list]
    with torch.no_grad():
        out["scores"] = _np(DF.retrieval_scores(
            params, torch.from_numpy(inp["user"]), mine(inp["cand"]), cfg,
            lookup))
    return out


def autograd_prog(ranks, seed: int) -> dict:
    return {"exchange": exchange_prog(ranks, seed),
            "lookup": lookup_prog(ranks, seed)}


# -- expert parallelism -------------------------------------------------------

D_MODEL, EP_B, EP_S = 16, 4, 8


def moe_settings(cf: float, n_experts: int = 6):
    from repro_torch.models import moe as M

    return M.MoESettings(n_experts=n_experts, top_k=2, d_expert_ff=32,
                         capacity_factor=cf)


def moe_inputs(seed: int, skew: float = 0.0, n_experts: int = 6,
               shape=(EP_B, EP_S)) -> dict:
    """The MoE layer's whole inputs: the port's seeded init at ep = 4 (six
    experts padded to eight, or eight) as numpy, tokens (B, S, 16), a
    regression target; `skew` leans the router toward expert 0 so
    buckets overflow."""
    from repro_torch.models import moe as M

    p = M.init_moe_params(torch.Generator().manual_seed(seed), D_MODEL,
                          moe_settings(8.0, n_experts), 4, torch.float32)
    p = {k: _np(v) for k, v in p._asdict().items()}
    rng = np.random.RandomState(seed)
    p["router"][:, 0] += skew
    return {"params": p,
            "x": rng.randn(*shape, D_MODEL).astype(np.float32),
            "target": rng.randn(*shape, D_MODEL).astype(np.float32)}


def token_block(a: np.ndarray, ranks) -> torch.Tensor:
    """This rank's tokens of a (B, S, ...) array: batch over "data",
    sequence over "model" (the reference's P(("data",), "model"))."""
    nd, di = ranks.axis_size("data"), ranks.axis_index("data")
    nm, mi = ranks.axis_size("model"), ranks.axis_index("model")
    b, s = a.shape[0] // nd, a.shape[1] // nm
    return torch.from_numpy(np.ascontiguousarray(
        a[di * b:(di + 1) * b, mi * s:(mi + 1) * s]))


def local_experts(p: dict, ranks):
    from repro_torch.models import moe as M

    nm, mi = ranks.axis_size("model"), ranks.axis_index("model")
    e = p["we_gate"].shape[0] // nm
    return M.MoEParams(**{k: torch.from_numpy(
        v if k == "router" else np.ascontiguousarray(v[mi * e:(mi + 1) * e]))
        for k, v in p.items()})


def ep_run(ranks, seed: int, cf: float, skew: float, grads: bool) -> dict:
    """The EP layer on this rank's tokens and experts: its output, drop
    count and, with `grads`, the gradients of the global mean squared
    error (each rank's part of it) w.r.t. its params and tokens. Six
    experts padded to eight with `grads` (the dense oracle's case), else
    DROP_EXPERTS."""
    from repro_torch.models import moe as M

    n_experts = 6 if grads else DROP_EXPERTS
    inp = moe_inputs(seed, skew, n_experts,
                     (EP_B, EP_S) if grads else DROP_SHAPE)
    p = local_experts(inp["params"], ranks)
    x, tgt = token_block(inp["x"], ranks), token_block(inp["target"], ranks)
    st = moe_settings(cf, n_experts)
    live = M.MoEParams(*(v.clone().requires_grad_(grads) for v in p))
    x = x.requires_grad_(grads)
    with torch.set_grad_enabled(grads):
        y, dropped = M.moe_ffn_ep_local(live, x, st, ranks=ranks,
                                        count_dropped=True)
    out = {"y": _np(y), "dropped": int(dropped)}
    if grads:
        (((y - tgt) ** 2).sum() / inp["x"].size).backward()
        out["grads"] = {k: _np(v.grad) for k, v in live._asdict().items()}
        out["x_grad"] = _np(x.grad)
    return out


def onehot_tokens(inp: dict) -> torch.Tensor:
    """16 decode tokens, (16, 1, 16)."""
    return torch.from_numpy(inp["x"].reshape(-1, 1, D_MODEL)[:16].copy())


def onehot_run(ranks, seed: int, capacity) -> np.ndarray:
    """The sharded one-hot decode: the same 16 tokens on every rank, this
    rank's experts."""
    from repro_torch.models import moe as M

    inp = moe_inputs(seed, skew=1.0)
    p = local_experts(inp["params"], ranks)
    x = onehot_tokens(inp)
    with torch.no_grad():
        return _np(M.moe_ffn_onehot(p, x, moe_settings(2.0), 8, capacity,
                                    ranks=ranks))


def ep_prog(ranks) -> dict:
    return {
        "exact": ep_run(ranks, 0, 8.0, 0.0, grads=True),
        "drops": {(seed, cf, skew): ep_run(ranks, seed, cf, skew, False)
                  for seed, cf, skew in EP_DROP_CASES},
    }


# (seed, capacity factor, router skew): buckets that overflow; eight
# experts, which the reference pads to no more at ep = 2 than at 4
EP_DROP_CASES = ((1, 0.25, 0.0), (2, 1.0, 3.0))
DROP_EXPERTS = 8
DROP_SHAPE = (8, 32)  # 64 tokens a rank: capacities past the +8 slack
LM_ARCHS = ("olmoe-1b-7b", "granite-moe-3b-a800m")
LM_PROMPT = (2, 8)


def lm_config(arch: str):
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch.train import reduced_lm

    cfg = reduced_lm(importlib.import_module(ARCHS[arch]).CONFIG)
    # capacity factor 8: neither ep = 1 nor ep = 2 drops, so both compute
    # the same function
    return dataclasses.replace(cfg, dtype=torch.float32, capacity_factor=8.0)


def lm_prompts(arch: str) -> np.ndarray:
    cfg = lm_config(arch)
    return np.random.RandomState(len(arch)).randint(
        0, cfg.vocab, LM_PROMPT).astype(np.int32)


def lm_prog(ranks) -> dict:
    """The reduced MoE LMs with their experts over the ranks (ep = world):
    prefill logits, Generator tokens and the prefill's drops; and the
    sharded one-hot decode layer."""
    from repro_torch.models import transformer as T
    from repro_torch.serve.decode import Generator

    out = {"onehot": {c: onehot_run(ranks, 4, c) for c in (None, 2)}}
    for arch in LM_ARCHS:
        cfg = lm_config(arch)
        params = T.init_params(torch.Generator().manual_seed(0), cfg,
                               ranks=ranks)
        tokens = torch.from_numpy(lm_prompts(arch))
        with torch.no_grad():
            logits = T.forward(params, tokens, cfg, ranks=ranks)[0]
        gen = Generator(cfg, params, device="cpu", max_len=24, ranks=ranks)
        toks = gen.generate(lm_prompts(arch), 8)
        out[arch] = {"logits": _np(logits), "tokens": toks,
                     "dropped": int(gen.moe_dropped)}
    return out


# -- GNN node sharding --------------------------------------------------------

GNN_CASES = (  # (arch, nodes, edges, edge slots, stream chunks, shuffle)
    ("meshgraphnet", 64, 500, 512, 0, True),
    ("meshgraphnet", 64, 500, 512, 0, False),
    ("graphcast", 256, 2000, 2048, 0, True),
    ("graphcast", 256, 2000, 2048, 0, False),
    ("graphcast", 256, 2000, 2048, 4, True),
)


def gnn_config(arch: str, chunks: int, shuffle: bool, sharded: bool):
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch.train import reduced_gnn

    cfg = reduced_gnn(arch, importlib.import_module(ARCHS[arch]).CONFIG)
    if arch == "graphcast":
        cfg = dataclasses.replace(cfg, edge_stream_chunks=chunks)
    if sharded:
        cfg = dataclasses.replace(cfg, node_spec=("data", "model"),
                                  shuffle_gather=shuffle)
    return cfg


def gnn_graph(arch: str, n: int, e: int, e_cap: int):
    from repro_torch.data.graphs import make_full_graph

    return make_full_graph(arch, n, e, e_cap,
                           6 if arch == "graphcast" else 8, 3, seed=1)


def gnn_params(arch: str, cfg):
    from repro_torch.configs.registry import _gnn_module

    return _gnn_module(arch).init_params(torch.Generator().manual_seed(2),
                                         cfg)


def sharded_loss(mod, cfg, ranks, n_global: int, d_out: int):
    """This rank's part of the global masked MSE (the squared errors of
    its nodes over the global count), so the ranks' parts sum to it."""
    def loss(params, g):
        pred = mod.apply(params, g, cfg, ranks=ranks)
        err = torch.where(g.node_mask[:, None],
                          (pred - g.extras["targets"]) ** 2, 0.0)
        return err.sum() / (n_global * d_out)

    return loss


def node_ops_prog(ranks) -> dict:
    """gather_nodes / scatter_add_nodes on the reference's drop case
    (make_full_graph n = 64, e = 512), and the run invariant: each
    sender's run of dst ids arrives ascending."""
    from repro_torch.data.graphs import make_full_graph, shard_graph
    from repro_torch.models.gnn import distributed as GD

    g = make_full_graph("meshgraphnet", 64, 512, 512, 8, 3, seed=0)
    gs = shard_graph(g, ranks)
    routes = gs.extras["routes"]["edges"]
    rng = np.random.RandomState(5)
    x = rng.randn(64, 8).astype(np.float32)
    msgs = rng.randn(512, 8).astype(np.float32)
    r, k, e = ranks.rank, 64 // ranks.world_size, 512 // ranks.world_size
    x_loc = torch.from_numpy(x[r * k:(r + 1) * k])
    m_loc = torch.from_numpy(msgs[r * e:(r + 1) * e])
    sc = routes.scatter[0]
    arrived = D.exchange(gs.dst[sc.send].long(), sc.group, sc.send_counts,
                         sc.recv_counts)
    return {
        "src": _np(GD.gather_nodes(x_loc, routes.src[0])),
        "dst": _np(GD.gather_nodes(x_loc, routes.dst[0])),
        "scatter": _np(GD.scatter_add_nodes(m_loc, sc)),
        "arrived": _np(arrived), "recv_counts": sc.recv_counts,
        "seg_ids": _np(sc.seg_ids), "merge": _np(sc.merge),
    }


def gnn_prog(ranks) -> dict:
    """Node-sharded MeshGraphNet and GraphCast (plain and streamed), with
    and without the shuffle: this rank's outputs and its param gradients
    (the weights replicated: every rank holds them whole); the node ops;
    the ogb_products binding against this rank context; the node group."""
    import torch.distributed as dist

    from repro_torch.configs import registry as TR
    from repro_torch.data.graphs import shard_graph

    out = {"node_ops": node_ops_prog(ranks), "models": {}}
    for arch, n, e, e_cap, chunks, shuffle in GNN_CASES:
        cfg = gnn_config(arch, chunks, shuffle, sharded=True)
        mod = TR._gnn_module(arch)
        params = gnn_params(arch, cfg)
        g = gnn_graph(arch, n, e, e_cap)
        gs = shard_graph(g, ranks, chunks)
        with torch.no_grad():
            y = mod.apply(params, gs, cfg, ranks=ranks)
        d_out = g.extras["targets"].shape[1]
        grads = TT.grad(sharded_loss(mod, cfg, ranks, n, d_out), params, gs,
                        has_aux=False)
        out["models"][(arch, chunks, shuffle)] = {
            "y": _np(y), "grads": [_np(v) for v in TT.leaves(grads)]}
    out["ogb_products"] = {}
    for arch in ("meshgraphnet", "graphcast"):
        dims = TR._gnn_dims(arch, TR.GNN_SHAPES["ogb_products"],
                            ranks.world_size)
        cfg = TR._gnn_cfg_for_shape(
            arch, importlib.import_module(TR.ARCHS[arch]).CONFIG, dims)
        out["ogb_products"][arch] = dict(
            dims, node_spec=cfg.node_spec, rank=ranks.rank,
            split=ranks.axis_size(cfg.node_spec),
            index=ranks.axis_index(cfg.node_spec))
    try:
        ranks.group(("model", "data"))
        reversed_refused = False
    except ValueError:
        reversed_refused = True
    out["node_group"] = {
        "world": ranks.group(("data", "model")) is dist.group.WORLD,
        "reversed_refused": reversed_refused}
    return out
