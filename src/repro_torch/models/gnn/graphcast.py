"""GraphCast-style encoder-processor-decoder mesh GNN (arXiv:2212.12794).

Grid nodes carry n_vars=227 features; a coarser mesh (n_mesh = N/4 here,
standing in for the refined icosahedron) runs 16 interaction-network
processor layers; grid→mesh and mesh→grid bipartite GNN blocks encode and
decode. Every aggregation is a dst-sorted segment sum — the MapSQ reduce,
the kernel on the card.

Mesh sizes derive from the shape (`configs.registry._gnn_dims`), so every
(arch × shape) cell is well-defined.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.models.gnn import common as C


@dataclasses.dataclass(frozen=True)
class GraphCastConfig:
    n_layers: int = 16  # processor depth
    d_hidden: int = 512
    n_vars: int = 227
    mesh_refinement: int = 6  # recorded; mesh size derives from the shape
    # axes the node dim shards over on large graphs (with a rank context)
    node_spec: tuple[str, ...] = ()
    remat: bool = False  # rematerialize each block in a training backward
    compute_dtype: object = torch.float32  # bf16 halves node/edge traffic
    shuffle_gather: bool = False  # MapSQ shuffle gather/scatter across ranks
    # stream the g2m/m2g edge sets in ~this many chunks (their edge
    # features are consumed once, so nothing O(E·d) ever lives). 0 = off.
    edge_stream_chunks: int = 0


def _block_init(gen, d, device):
    return {
        "edge": C.init_mlp(gen, [3 * d, d, d], device=device),
        "node": C.init_mlp(gen, [2 * d, d, d], device=device),
    }


def init_params(gen: torch.Generator | None, cfg: GraphCastConfig, *,
                device=None) -> dict:
    """Seeded random weights drawn from `gen` on its device (`gen=None`:
    on `device`, e.g. "meta" for the shapes alone)."""
    d = cfg.d_hidden
    return {
        "enc_grid": C.init_mlp(gen, [cfg.n_vars, d, d], device=device),
        "mesh_init": C.normal(gen, (1, d), 0.02, device),
        "enc_g2m_edge": C.init_mlp(gen, [4, d, d], device=device),
        "g2m": _block_init(gen, d, device),
        "enc_mesh_edge": C.init_mlp(gen, [4, d, d], device=device),
        "processor": [_block_init(gen, d, device)
                      for _ in range(cfg.n_layers)],
        "enc_m2g_edge": C.init_mlp(gen, [4, d, d], device=device),
        "m2g": _block_init(gen, d, device),
        "dec_grid": C.init_mlp(gen, [d, d, cfg.n_vars], device=device),
    }


def params_from_numpy(tree: dict, cfg: GraphCastConfig, device=None) -> dict:
    """The reference's params (numpy leaves) on `device` (the card unless
    the caller passes another), bit for bit."""
    return C.tree_from_numpy(tree, init_params(None, cfg, device="meta"),
                             resolve_device(device))


def _bipartite_block(p, e_feat, x_src_tab, x_dst_tab, src, dst, mask, n_dst,
                     sh: "_Shard"):
    """Interaction-network block over a (possibly bipartite) edge set."""
    xs = C.take_nodes(x_src_tab, src, mask, **sh.of("src", 0))
    xd = C.take_nodes(x_dst_tab, dst, mask, **sh.of("dst", 0))
    e_in = torch.cat([e_feat, xs, xd], dim=-1)
    e = e_feat + C.layer_norm(C.mlp(p["edge"], e_in)).to(e_feat.dtype)
    agg = C.aggregate_nodes(e, dst, n_dst, mask, **sh.of("scatter", 0))
    x = x_dst_tab + C.layer_norm(
        C.mlp(p["node"], torch.cat([x_dst_tab, agg], dim=-1))
    ).to(x_dst_tab.dtype)
    return e, x


def _pick_chunks(e: int, want: int) -> int:
    """Largest divisor of e//512 that is <= want (chunks must keep the
    512-way edge sharding divisible)."""
    base = max(1, e // 512)
    best = 1
    for k in range(1, min(want, base) + 1):
        if base % k == 0:
            best = k
    return best


def _bipartite_block_streamed(p, enc_p, raw_ef, x_src_tab, x_dst_tab, src,
                              dst, mask, n_dst, n_chunks, sh: "_Shard"):
    """One-shot edge sets (g2m / m2g) processed in chunks — encode chunk →
    gather endpoints → edge MLP → partial aggregate, summed into one
    accumulator in chunk order (the reference's scan). No O(E·d) tensor is
    ever resident. Node-sharded, each rank cuts its edge slice into the
    chunks its routes were planned for (as many as the whole graph's)."""
    e = src.shape[0]
    n_chunks = sh.chunks() or _pick_chunks(e, n_chunks)
    c = e // n_chunks
    dt = x_dst_tab.dtype
    d = x_dst_tab.shape[-1]

    def chunked(a):
        return a.reshape((n_chunks, c) + tuple(a.shape[1:]))

    agg = torch.zeros((n_dst, d), dtype=dt, device=x_dst_tab.device)
    for i, (ef_c, src_c, dst_c, m_c) in enumerate(zip(
            chunked(raw_ef), chunked(src), chunked(dst), chunked(mask))):
        e_enc = C.layer_norm(C.mlp(enc_p, ef_c.to(dt))).to(dt)
        xs = C.take_nodes(x_src_tab, src_c, m_c, **sh.of("src", i))
        xd = C.take_nodes(x_dst_tab, dst_c, m_c, **sh.of("dst", i))
        e_in = torch.cat([e_enc, xs, xd], dim=-1)
        e_out = e_enc + C.layer_norm(C.mlp(p["edge"], e_in)).to(dt)
        agg = agg + C.aggregate_nodes(e_out, dst_c, n_dst, m_c,
                                      **sh.of("scatter", i))
    return x_dst_tab + C.layer_norm(
        C.mlp(p["node"], torch.cat([x_dst_tab, agg], dim=-1))
    ).to(dt)


class _Shard:
    """How one edge set's node ops run: plain, or node-sharded over
    `cfg.node_spec` of `ranks` (with the shuffle: along the set's
    routes)."""

    def __init__(self, g: C.GraphBatch, name: str, cfg: GraphCastConfig,
                 ranks, shuffle: bool):
        self.spec, self.shuffle, self.ranks = cfg.node_spec, shuffle, ranks
        self.routes = C.edge_routes(g, name, cfg.node_spec, shuffle, ranks)

    def chunks(self) -> int:
        """The chunks the routes were planned for (0: no routes)."""
        return len(self.routes.src) if self.routes is not None else 0

    def of(self, end: str, chunk: int) -> dict:
        """The keywords of a node op of `end` ("src", "dst" or "scatter")
        on chunk `chunk`."""
        route = (getattr(self.routes, end)[chunk]
                 if self.routes is not None else None)
        return dict(node_spec=self.spec, shuffle=self.shuffle,
                    ranks=self.ranks, route=route)


def apply(params: dict, g: C.GraphBatch, cfg: GraphCastConfig, *,
          ranks=None) -> torch.Tensor:
    """Grid outputs (N, n_vars). With `ranks` and `cfg.node_spec`, `g` is
    this rank's shard (`data.graphs.shard_graph`, its grid and mesh row
    blocks and edge slices) and so are the outputs. With `ranks` and no
    node_spec, `g` holds this rank's slice of every edge set and every
    node table whole (`common`'s edge cut)."""
    ex = g.extras
    n_grid = g.n_nodes
    n_mesh = ex["mesh_feat_init"].shape[0]
    dt = cfg.compute_dtype
    xg = C.layer_norm(C.mlp(params["enc_grid"], g.node_feat.to(dt))).to(dt)
    xm = params["mesh_init"].to(dt).expand(n_mesh, cfg.d_hidden)
    blk = C.remat(_bipartite_block, cfg.remat)
    sblk = C.remat(_bipartite_block_streamed, cfg.remat)
    stream = cfg.edge_stream_chunks
    # the streamed sets always take the shuffle, as the reference's do
    g2m, mesh, m2g = (
        _Shard(g, name, cfg, ranks,
               cfg.shuffle_gather or bool(stream and name != "mesh"))
        for name in ("g2m", "mesh", "m2g"))
    if stream:  # one-shot edge sets never materialize at O(E·d)
        xm = sblk(params["g2m"], params["enc_g2m_edge"], ex["g2m_feat"], xg,
                  xm, g.src, g.dst, g.edge_mask, n_mesh, stream, g2m)
    else:
        # encoder: grid -> mesh (edges of the GraphBatch ARE the g2m set)
        e_g2m = C.layer_norm(C.mlp(params["enc_g2m_edge"],
                                   ex["g2m_feat"].to(dt))).to(dt)
        _, xm = blk(params["g2m"], e_g2m, xg, xm, g.src, g.dst, g.edge_mask,
                    n_mesh, g2m)
    # processor: 16 interaction layers on the mesh graph (edge features are
    # carried across layers, so these stay resident — mesh edges are small)
    e_m = C.layer_norm(C.mlp(params["enc_mesh_edge"],
                             ex["mesh_edge_feat"].to(dt))).to(dt)
    for p in params["processor"]:
        e_m, xm = blk(p, e_m, xm, xm, ex["mesh_src"], ex["mesh_dst"],
                      ex["mesh_mask"], n_mesh, mesh)
    # decoder: mesh -> grid
    if stream:
        xg = sblk(params["m2g"], params["enc_m2g_edge"], ex["m2g_feat"], xm,
                  xg, ex["m2g_src"], ex["m2g_dst"], ex["m2g_mask"], n_grid,
                  stream, m2g)
    else:
        e_m2g = C.layer_norm(C.mlp(params["enc_m2g_edge"],
                                   ex["m2g_feat"].to(dt))).to(dt)
        _, xg = blk(params["m2g"], e_m2g, xm, xg, ex["m2g_src"],
                    ex["m2g_dst"], ex["m2g_mask"], n_grid, m2g)
    out = C.mlp(params["dec_grid"], xg).float()
    return torch.where(g.node_mask[:, None], out, 0.0)


def loss_fn(params, g: C.GraphBatch, cfg: GraphCastConfig, *, ranks=None):
    """The masked MSE; with `ranks`, over this rank's grid nodes."""
    pred = apply(params, g, cfg, ranks=ranks)
    return C.mse_loss(pred, g.extras["targets"], g.node_mask)
