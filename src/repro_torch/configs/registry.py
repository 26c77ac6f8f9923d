"""Arch × shape registry: arch id -> config module (each holds `CONFIG`
and `FAMILY`), the input shapes of each family, the GNN shape bindings
(`_gnn_dims`, `_gnn_cfg_for_shape`, `_gnn_model_flops`) that size a (gnn
arch, shape) cell, `DEFAULT_OPT`, the optimizer state's specs
(`zero1_spec`, `_opt_specs`), and the GNN and DeepFM train steps of the
reference's cells (`gnn_train_step`, `deepfm_train_step`), on one
process or across ranks. `build_cell` and its per-family cells are not
ported yet."""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch import tree as TT
from repro_torch.core import specs as S
from repro_torch.optim.adamw import AdamWConfig, adamw_update

ARCHS: dict[str, str] = {
    # arch id -> config module
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "schnet": "repro_torch.configs.schnet",
    "graphcast": "repro_torch.configs.graphcast",
    "gat-cora": "repro_torch.configs.gat_cora",
    "meshgraphnet": "repro_torch.configs.meshgraphnet",
    "deepfm": "repro_torch.configs.deepfm",
}

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}
GNN_SHAPES = {
    "full_graph_sm": dict(kind="full", n_nodes=2708, n_edges=10556,
                          d_feat=1433, n_classes=7),
    "minibatch_lg": dict(kind="minibatch", n_nodes=232_965,
                         n_edges=114_615_892, d_feat=602, n_classes=41,
                         batch_nodes=1024, fanout=(15, 10)),
    "ogb_products": dict(kind="full", n_nodes=2_449_029, n_edges=61_859_140,
                         d_feat=100, n_classes=47),
    "molecule": dict(kind="batched", n_nodes=30, n_edges=64, batch=128,
                     d_feat=16, n_classes=1),
}
RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65_536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262_144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_448),
    # n_candidates padded from 1,000,000 to the next multiple of 512 chips
}


def SHAPES_FOR(arch: str) -> dict[str, dict]:
    return {"lm": LM_SHAPES, "gnn": GNN_SHAPES,
            "recsys": RECSYS_SHAPES}[family_of(arch)]


def family_of(arch: str) -> str:
    return importlib.import_module(ARCHS[arch]).FAMILY


def archs_of(family: str) -> list[str]:
    """The arch ids of one family ("lm", "gnn" or "recsys"), sorted."""
    return sorted(a for a in ARCHS if family_of(a) == family)


def lm_layer_count(arch: str) -> int:
    return importlib.import_module(ARCHS[arch]).CONFIG.n_layers


DEFAULT_OPT = AdamWConfig()

# the reference's sharding helpers (`registry.py:110-128`), on the port's
# spec tuples: ZeRO-1's "data" cut of m and v (core/specs.py)
zero1_spec = S.zero1_spec
_opt_specs = S.opt_specs


def _all_axes(multi_pod: bool) -> tuple[str, ...]:
    return ("pod", "data", "model") if multi_pod else ("data", "model")


def _round_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _gnn_dims(arch: str, sh: dict, n_dev: int) -> dict:
    """Device-visible graph dims for a (gnn arch, shape) cell."""
    kind = sh["kind"]
    if kind == "minibatch":
        from repro_torch.models.gnn.sampler import block_capacity

        n, e = block_capacity(sh["batch_nodes"], list(sh["fanout"]))
    elif kind == "batched":
        n, e = sh["n_nodes"] * sh["batch"], sh["n_edges"] * sh["batch"]
    else:
        n, e = sh["n_nodes"], sh["n_edges"]
    e = _round_to(e, 512)  # edge dim shards over up to 512 chips
    n_graphs = sh.get("batch", 1)
    # Large graphs (>= 1M nodes) shard the node dim over every mesh axis
    # (padded to 512) and run node/edge activations in bf16: replicated
    # node tensors do not fit one chip at 2.45M nodes.
    shard_nodes = n >= 1_000_000
    if shard_nodes:
        n = _round_to(n, 512)
    d = dict(n=n, e=e, n_graphs=n_graphs, d_feat=sh["d_feat"],
             n_classes=sh["n_classes"], shard_nodes=shard_nodes)
    # graphcast mesh sizes derive from the shape
    d["n_mesh"] = _round_to(max(8, n // 4), 512 if shard_nodes else 1)
    d["e_mesh"] = _round_to(max(64, d["n_mesh"] * 7), 512)
    return d


def _gnn_module(arch: str):
    from repro_torch.models.gnn import gat, graphcast, meshgraphnet, schnet

    return {"gat-cora": gat, "schnet": schnet, "meshgraphnet": meshgraphnet,
            "graphcast": graphcast}[arch]


def _gnn_node_feat_dim(arch: str, cfg, dims: dict) -> int:
    if arch == "graphcast":
        return cfg.n_vars
    if arch == "schnet":
        return 1  # schnet reads species/positions from extras
    return dims["d_feat"]


def _gnn_cfg_for_shape(arch: str, cfg, dims: dict, multi_pod: bool = False):
    """Bind per-shape input dims into the arch config."""
    if arch == "gat-cora":
        cfg = dataclasses.replace(cfg, d_in=dims["d_feat"],
                                  n_classes=dims["n_classes"])
    if arch == "meshgraphnet":
        cfg = dataclasses.replace(cfg, d_node_in=dims["d_feat"])
    if dims.get("shard_nodes") and hasattr(cfg, "node_spec"):
        # node dim sharded over every axis, blocks remat'd, activations
        # bf16, gathers/scatters via the MapSQ shuffle, one-shot edge sets
        # streamed (graphcast only); `apply(ranks=)` over a mesh of those
        # axes runs it on a rank's shard (`data.graphs.shard_graph`), and
        # without ranks on the whole graph
        extra = {}
        if hasattr(cfg, "edge_stream_chunks"):
            extra["edge_stream_chunks"] = 16
        cfg = dataclasses.replace(cfg, node_spec=_all_axes(multi_pod),
                                  remat=True, compute_dtype=torch.bfloat16,
                                  shuffle_gather=True, **extra)
    return cfg


def _gnn_model_flops(arch: str, cfg, dims: dict) -> float:
    n, e = dims["n"], dims["e"]
    if arch == "gat-cora":
        d_in, h, d = cfg.d_in, cfg.n_heads, cfg.d_hidden
        fwd = 2 * n * d_in * h * d + 6 * e * h * d
        fwd += 2 * n * (h * d) * cfg.n_classes + 6 * e * cfg.n_classes
    elif arch == "schnet":
        d, r = cfg.d_hidden, cfg.n_rbf
        per = 2 * e * (r * d + d * d) + 2 * e * d + 6 * n * d * d
        fwd = cfg.n_interactions * per + 2 * n * d * d
    elif arch == "meshgraphnet":
        d = cfg.d_hidden
        per = 2 * e * (3 * d + d) * d + 2 * n * (2 * d + d) * d
        fwd = cfg.n_layers * per + 2 * n * cfg.d_node_in * d + 2 * e * 4 * d
    else:  # graphcast
        d = cfg.d_hidden
        nm, em = dims["n_mesh"], dims["e_mesh"]
        blk = lambda ee, nn: 2 * ee * (3 * d + d) * d + 2 * nn * (2 * d + d) * d
        fwd = (2 * n * cfg.n_vars * d + blk(e, nm)
               + cfg.n_layers * blk(em, nm) + blk(e, n)
               + 2 * n * d * cfg.n_vars)
    return 3.0 * fwd  # train = fwd + bwd(2x)


# ---------------------------------------------------------------------------
# Train steps (the reference's GNN and DeepFM cells)
# ---------------------------------------------------------------------------

def gnn_train_step(mod, cfg, opt_cfg: AdamWConfig = DEFAULT_OPT, ranks=None):
    """train_step(params, opt_state, graph) -> (params, opt_state, metrics):
    the gradient of `mod.loss_fn` over every param, then AdamW (metrics:
    grad_norm, lr).

    `ranks` (MeshGraphNet or GraphCast with `cfg.node_spec`, the graph
    this rank's shard from `data.graphs.shard_graph`, the params and the
    opt state whole on every rank): each rank's loss is its nodes' part
    of the global masked MSE (its squared errors over the global count),
    so the ranks' parts sum to the one-process loss; a param's gradient
    is the sum of the ranks' (their mean, times the world), and every
    rank takes the same AdamW step."""
    if ranks is None:
        def train_step(params, opt_state, graph):
            grads = TT.grad(mod.loss_fn, params, graph, cfg, has_aux=False)
            return adamw_update(opt_cfg, grads, opt_state, params)

        return train_step

    group = ranks.group(tuple(ranks.mesh.axis_names))

    def loss(params, g):
        pred = mod.apply(params, g, cfg, ranks=ranks)
        err = torch.where(g.node_mask[:, None],
                          (pred - g.extras["targets"]) ** 2, 0.0)
        count = S.all_reduce_(g.node_mask.sum().reshape(1), group)
        return err.sum() / (count[0] * pred.shape[-1]).clamp_min(1)

    def train_step(params, opt_state, graph):
        grads = TT.grad(loss, params, graph, has_aux=False)
        grads = S.reduce_grads(grads, TT.map(lambda _: (), params), ranks)
        return adamw_update(opt_cfg, grads, opt_state, params)

    return train_step


def deepfm_train_step(cfg, opt_cfg: AdamWConfig = DEFAULT_OPT,
                      lookup_fn=None, ranks=None):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics)
    for DeepFM: the gradient of `bce_loss` on batch {"ids" (B, F) int32,
    "labels" (B,) float32} (the tables get dense gradients, as
    `jax.grad` gives), then AdamW.

    `ranks` (a ("data", "model") mesh): the params are this rank's by
    `deepfm.param_specs` (`shard_params`: the table and fm_w row-cut over
    "model"), the opt state `adamw_init(params, param_specs, ranks)`'s (m
    and v by ZeRO-1), the batch this rank's rows (the global batch cut
    over every axis jointly, as the reference's lookup takes its ids),
    read through `make_sharded_lookup`. Each rank seeds its backward
    with 1 / world of its rows' mean loss; the tables' gradients come
    back through the lookup's exchanges to the rows' owners and are
    summed over "data", the dense MLP's and the bias's over every axis
    (the mean over the ranks' batches)."""
    from repro_torch.models.recsys import deepfm as D

    specs = None
    if ranks is not None:
        lookup_fn = D.make_sharded_lookup(ranks)
        specs = D.param_specs(cfg)

    def loss(params, ids, labels):
        out = D.bce_loss(params, ids, labels, cfg, lookup_fn)
        return out if ranks is None else out / ranks.world_size

    def train_step(params, opt_state, batch):
        grads = TT.grad(loss, params, batch["ids"], batch["labels"],
                        has_aux=False)
        if ranks is not None:
            grads = S.reduce_grads(grads, specs, ranks)
        return adamw_update(opt_cfg, grads, opt_state, params, specs=specs,
                            ranks=ranks)

    return train_step
