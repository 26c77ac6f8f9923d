"""MeshGraphNet (arXiv:2010.03409): encode-process-decode with residual
edge/node update blocks. n_layers=15, d=128, 2-layer MLPs + LayerNorm.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.models.gnn import common as C


@dataclasses.dataclass(frozen=True)
class MGNConfig:
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_node_in: int = 8
    d_edge_in: int = 4
    d_out: int = 3
    # axes the node dim shards over on large graphs (with a rank context)
    node_spec: tuple[str, ...] = ()
    remat: bool = False  # rematerialize each block in a training backward
    compute_dtype: object = None  # a torch dtype (bf16 on large graphs)
    shuffle_gather: bool = False  # MapSQ shuffle gather/scatter across ranks


def _mlp_sizes(cfg: MGNConfig, d_in: int) -> list[int]:
    return [d_in] + [cfg.d_hidden] * cfg.mlp_layers


def init_params(gen: torch.Generator | None, cfg: MGNConfig, *,
                device=None) -> dict:
    """Seeded random weights drawn from `gen` on its device (`gen=None`:
    on `device`, e.g. "meta" for the shapes alone)."""
    d = cfg.d_hidden
    blocks = []
    for _ in range(cfg.n_layers):
        blocks.append({
            "edge": C.init_mlp(gen, _mlp_sizes(cfg, 3 * d), device=device),
            "node": C.init_mlp(gen, _mlp_sizes(cfg, 2 * d), device=device),
        })
    return {
        "enc_node": C.init_mlp(gen, _mlp_sizes(cfg, cfg.d_node_in),
                               device=device),
        "enc_edge": C.init_mlp(gen, _mlp_sizes(cfg, cfg.d_edge_in),
                               device=device),
        "blocks": blocks,
        "dec": C.init_mlp(gen, [d, d, cfg.d_out], device=device),
    }


def params_from_numpy(tree: dict, cfg: MGNConfig, device=None) -> dict:
    """The reference's params (numpy leaves) on `device` (the card unless
    the caller passes another), bit for bit."""
    return C.tree_from_numpy(tree, init_params(None, cfg, device="meta"),
                             resolve_device(device))


def _block(p: dict, x: torch.Tensor, e: torch.Tensor, g: C.GraphBatch,
           cfg: MGNConfig, ranks):
    """One residual edge / node update. Returns (x, e)."""
    dt = x.dtype
    ns, sg = cfg.node_spec, cfg.shuffle_gather
    r = C.edge_routes(g, "edges", ns, sg, ranks)
    xs = C.take_nodes(x, g.src, g.edge_mask, ns, sg, ranks=ranks,
                      route=r and r.src[0])
    xd = C.take_nodes(x, g.dst, g.edge_mask, ns, sg, ranks=ranks,
                      route=r and r.dst[0])
    e_in = torch.cat([e, xs, xd], dim=-1)
    e = e + C.layer_norm(C.mlp(p["edge"], e_in)).to(dt)
    agg = C.aggregate_nodes(e, g.dst, g.n_nodes, g.edge_mask, ns, sg,
                            ranks=ranks, route=r and r.scatter[0])
    x = x + C.layer_norm(
        C.mlp(p["node"], torch.cat([x, agg], dim=-1))).to(dt)
    return x, e


def apply(params: dict, g: C.GraphBatch, cfg: MGNConfig, *,
          ranks=None) -> torch.Tensor:
    """Node outputs (N, d_out). With `ranks` and `cfg.node_spec`, `g` is
    this rank's shard (`data.graphs.shard_graph`) and so are the
    outputs: its row block of the nodes. With `ranks` and no node_spec,
    `g` holds this rank's slice of the edges and every node table whole
    (`common`'s edge cut; `data.graphs.edge_cut_graph`)."""
    dt = cfg.compute_dtype or g.node_feat.dtype
    x = C.layer_norm(C.mlp(params["enc_node"], g.node_feat.to(dt))).to(dt)
    e = C.layer_norm(C.mlp(params["enc_edge"],
                           g.extras["edge_feat"].to(dt))).to(dt)
    blk = C.remat(_block, cfg.remat)
    for p in params["blocks"]:
        x, e = blk(p, x, e, g, cfg, ranks)
    out = C.mlp(params["dec"], x)
    return torch.where(g.node_mask[:, None], out, 0.0)


def loss_fn(params, g: C.GraphBatch, cfg: MGNConfig, *, ranks=None):
    """The masked MSE; with `ranks`, over this rank's nodes."""
    pred = apply(params, g, cfg, ranks=ranks)
    return C.mse_loss(pred, g.extras["targets"], g.node_mask)
