"""Synthetic graph generators matching the assigned GNN shapes, plus the
CSR-backed minibatch pipeline (real neighbor sampling, fanout 15-10).

Edges are ALWAYS emitted sorted by dst — the MapSQ Sort phase executed once
at data-load time, so device-side aggregation is a sorted segment reduce.
Batches are numpy arrays; `to_device` makes them tensors, `shard_graph`
one rank's shard of a node-sharded graph, and `edge_cut_graph` one
rank's part of an edge-cut one.
"""
from __future__ import annotations

import dataclasses

import numpy as np

import torch

from repro_torch import resolve_device
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.models.gnn.sampler import CSRGraph, block_capacity, sample_block


def _pad_edges(src, dst, e_cap, n_sentinel):
    e = len(src)
    ps = np.full(e_cap, 0, np.int32)
    pd = np.full(e_cap, n_sentinel - 1, np.int32)
    ps[:e] = src
    pd[:e] = dst
    mask = np.zeros(e_cap, bool)
    mask[:e] = True
    return ps, pd, mask


def random_graph(rng: np.random.Generator, n: int, e: int,
                 sorted_dst: bool = True):
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    if sorted_dst:
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
    return src, dst


def make_full_graph(arch: str, n: int, e: int, e_cap: int, d_feat: int,
                    n_classes: int, seed: int = 0,
                    extras_builder=None) -> GraphBatch:
    rng = np.random.default_rng(seed)
    src, dst = random_graph(rng, n, e)
    ps, pd, emask = _pad_edges(src, dst, e_cap, n)
    g = GraphBatch(
        node_feat=np.asarray(rng.normal(size=(n, d_feat)), np.float32),
        src=ps, dst=pd,
        node_mask=np.ones(n, bool), edge_mask=emask,
        graph_ids=np.zeros(n, np.int32),
        extras={},
    )
    return _with_extras(g, arch, rng, n, e_cap, n_classes)


def make_molecule_batch(arch: str, n_per: int, e_per: int, batch: int,
                        n_classes: int, seed: int = 0) -> GraphBatch:
    rng = np.random.default_rng(seed)
    n, e = n_per * batch, e_per * batch
    srcs, dsts, gids = [], [], []
    for b in range(batch):
        s, d = random_graph(rng, n_per, e_per)
        srcs.append(s + b * n_per)
        dsts.append(d + b * n_per)
        gids.append(np.full(n_per, b, np.int32))
    g = GraphBatch(
        node_feat=np.asarray(rng.normal(size=(n, 16)), np.float32),
        src=np.concatenate(srcs), dst=np.concatenate(dsts),
        node_mask=np.ones(n, bool), edge_mask=np.ones(e, bool),
        graph_ids=np.concatenate(gids),
        extras={},
    )
    return _with_extras(g, arch, rng, n, e, n_classes, n_graphs=batch)


def _with_extras(g: GraphBatch, arch: str, rng, n: int, e_cap: int,
                 n_classes: int, n_graphs: int = 1) -> GraphBatch:
    ex: dict = {}
    if arch == "gat-cora":
        ex["labels"] = rng.integers(0, n_classes, n).astype(np.int32)
        ex["train_mask"] = rng.random(n) < 0.3
    elif arch == "schnet":
        ex["positions"] = np.asarray(rng.normal(size=(n, 3)) * 3, np.float32)
        ex["species"] = rng.integers(1, 20, n).astype(np.int32)
        ex["energy"] = np.asarray(rng.normal(size=(n_graphs,)), np.float32)
        ex["graph_mask"] = np.ones(n_graphs, bool)
    elif arch == "meshgraphnet":
        ex["edge_feat"] = np.asarray(rng.normal(size=(e_cap, 4)), np.float32)
        ex["targets"] = np.asarray(rng.normal(size=(n, 3)), np.float32)
    elif arch == "graphcast":
        nm = max(8, n // 4)
        em = max(64, nm * 7)
        ms, md = random_graph(rng, nm, em)
        m2s = rng.integers(0, nm, e_cap).astype(np.int32)
        m2d = np.sort(rng.integers(0, n, e_cap).astype(np.int32))
        ex.update(
            mesh_feat_init=np.zeros((nm, 1), np.float32),
            g2m_feat=np.asarray(rng.normal(size=(e_cap, 4)), np.float32),
            mesh_edge_feat=np.asarray(rng.normal(size=(em, 4)), np.float32),
            mesh_src=ms, mesh_dst=md, mesh_mask=np.ones(em, bool),
            m2g_feat=np.asarray(rng.normal(size=(e_cap, 4)), np.float32),
            m2g_src=m2s, m2g_dst=m2d, m2g_mask=np.ones(e_cap, bool),
            # targets dim tracks the grid feature dim (= the model's n_vars)
            targets=np.asarray(
                rng.normal(size=(n, g.node_feat.shape[1])), np.float32),
        )
        # graphcast: GraphBatch.dst indexes MESH nodes (g2m edges)
        g = g._replace(dst=np.sort(rng.integers(0, nm, e_cap))
                       .astype(np.int32))
    return g._replace(extras=ex)


@dataclasses.dataclass
class MinibatchPipeline:
    """The minibatch_lg pipeline: CSR graph + layered neighbor sampling.

    RNG state advances deterministically with `step` (checkpointable).
    """

    arch: str
    n_nodes: int
    n_edges: int
    d_feat: int
    n_classes: int
    batch_nodes: int = 1024
    fanout: tuple[int, ...] = (15, 10)
    seed: int = 0
    step: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        src, dst = random_graph(rng, self.n_nodes, self.n_edges,
                                sorted_dst=False)
        self.csr = CSRGraph.from_edges(src, dst, self.n_nodes)
        self.feats = np.asarray(
            rng.normal(size=(self.n_nodes, self.d_feat)), np.float32
        )
        self.labels = rng.integers(0, self.n_classes, self.n_nodes).astype(
            np.int32
        )

    def __next__(self) -> GraphBatch:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, 1, self.step])
        )
        seeds = rng.integers(0, self.n_nodes, self.batch_nodes)
        nodes, src, dst, emask = sample_block(self.csr, seeds,
                                              list(self.fanout), rng)
        n_cap, e_cap = block_capacity(self.batch_nodes, list(self.fanout))
        assert len(nodes) == n_cap and len(src) == e_cap
        train_mask = np.zeros(n_cap, bool)
        train_mask[: self.batch_nodes] = True
        g = GraphBatch(
            node_feat=self.feats[nodes],
            src=src.astype(np.int32), dst=dst.astype(np.int32),
            node_mask=np.ones(n_cap, bool), edge_mask=emask,
            graph_ids=np.zeros(n_cap, np.int32),
            extras={"labels": self.labels[nodes], "train_mask": train_mask},
        )
        self.step += 1
        return g

    def state_dict(self):
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, st):
        self.seed, self.step = int(st["seed"]), int(st["step"])


# GraphCast's edge sets in extras: name -> (src, dst, mask, edge arrays),
# src into the mesh table and dst into the mesh ("mesh") or the grid
# ("m2g"); the GraphBatch's own edges are the grid's ("edges") or, for
# GraphCast, the g2m set (dst into the mesh)
_EXTRA_EDGE_SETS = {
    "mesh": ("mesh_src", "mesh_dst", "mesh_mask", ("mesh_edge_feat",)),
    "m2g": ("m2g_src", "m2g_dst", "m2g_mask", ("m2g_feat",)),
}
_EDGE_EXTRAS = ("edge_feat", "g2m_feat")  # per edge of the GraphBatch
_GRID_NODE_EXTRAS = ("targets", "labels", "train_mask", "positions",
                     "species")
_MESH_NODE_EXTRAS = ("mesh_feat_init",)


def shard_graph(g: GraphBatch, ranks, stream_chunks: int = 0) -> GraphBatch:
    """This rank's shard of the whole graph `g` (numpy arrays, e.g. from
    `make_full_graph`), node-sharded over every mesh axis of `ranks`
    (the registry's large-graph binding, `node_spec` = all axes), on the
    ranks' device.

    Every node table (the grid's and GraphCast's mesh) is cut into
    contiguous row blocks of n / world, and every edge set (its ids, mask
    and features) into contiguous slices of E / world; ids stay global.
    The shuffle's routes of each edge set are planned here, once, and
    carried in `extras["routes"]` (see `models/gnn/distributed.py`);
    with `stream_chunks` (GraphCast's edge_stream_chunks), its g2m and m2g
    sets are planned in as many chunks as the one-device stream cuts the
    whole set into. Sizes that do not split raise."""
    from repro_torch.models.gnn.distributed import plan_edges
    from repro_torch.models.gnn.graphcast import _pick_chunks

    axes = tuple(ranks.mesh.axis_names)
    ndev, r = ranks.axis_size(axes), ranks.axis_index(axes)
    dev = ranks.device

    def block(a):
        if a.shape[0] % ndev:
            raise ValueError(f"{a.shape[0]} rows do not split over {ndev} "
                             "ranks")
        k = a.shape[0] // ndev
        return torch.from_numpy(np.ascontiguousarray(a[r * k:(r + 1) * k])
                                ).to(dev)

    ex = g.extras
    n = g.n_nodes
    graphcast = "mesh_src" in ex
    n_mesh = ex["mesh_feat_init"].shape[0] if graphcast else n

    def chunks(e: int) -> int:
        return _pick_chunks(e, stream_chunks) if stream_chunks else 1

    # (name, src, dst, mask, src table rows, dst table rows, chunks)
    sets = [("g2m" if graphcast else "edges", g.src, g.dst, g.edge_mask, n,
             n_mesh, chunks(g.n_edges) if graphcast else 1)]
    if graphcast:
        sets += [("mesh", ex["mesh_src"], ex["mesh_dst"], ex["mesh_mask"],
                  n_mesh, n_mesh, 1),
                 ("m2g", ex["m2g_src"], ex["m2g_dst"], ex["m2g_mask"],
                  n_mesh, n, chunks(ex["m2g_src"].shape[0]))]
    routes = {name: plan_edges(src, dst, mask, n_src, n_dst, ranks, axes, c)
              for name, src, dst, mask, n_src, n_dst, c in sets}
    cut = set(_EDGE_EXTRAS + _GRID_NODE_EXTRAS + _MESH_NODE_EXTRAS)
    for src, dst, mask, feats in _EXTRA_EDGE_SETS.values():
        cut.update((src, dst, mask) + feats)
    extras = {k: block(v) if k in cut else
              torch.from_numpy(np.ascontiguousarray(v)).to(dev)
              for k, v in ex.items()}
    extras["routes"] = routes
    return GraphBatch(node_feat=block(g.node_feat), src=block(g.src),
                      dst=block(g.dst), node_mask=block(g.node_mask),
                      edge_mask=block(g.edge_mask),
                      graph_ids=block(g.graph_ids), extras=extras)


def edge_cut_graph(g: GraphBatch, ranks) -> GraphBatch:
    """This rank's part of the whole graph `g` (numpy arrays) in the edge
    cut of the registry's small-graph cells (`models/gnn/common.py`):
    every edge set (ids, mask and features) cut into contiguous slices of
    E / world over every mesh axis of `ranks`, every node table whole, on
    the ranks' device. Sizes that do not split raise."""
    axes = tuple(ranks.mesh.axis_names)
    ndev, r = ranks.axis_size(axes), ranks.axis_index(axes)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(ranks.device)

    def cut(a):
        if a.shape[0] % ndev:
            raise ValueError(f"{a.shape[0]} edges do not split over {ndev} "
                             "ranks")
        k = a.shape[0] // ndev
        return t(a[r * k:(r + 1) * k])

    edge = set(_EDGE_EXTRAS)
    for src, dst, mask, feats in _EXTRA_EDGE_SETS.values():
        edge.update((src, dst, mask) + feats)
    return GraphBatch(node_feat=t(g.node_feat), src=cut(g.src),
                      dst=cut(g.dst), node_mask=t(g.node_mask),
                      edge_mask=cut(g.edge_mask), graph_ids=t(g.graph_ids),
                      extras={k: cut(v) if k in edge else t(v)
                              for k, v in g.extras.items()})


def to_device(g: GraphBatch, device=None) -> GraphBatch:
    """A GraphBatch of numpy arrays as tensors on `device` (the card unless
    the caller passes another), every array's type kept (int32 ids stay
    int32, as the segment kernel takes them)."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return GraphBatch(
        *(t(a) for a in g[:-1]),
        extras={k: t(v) for k, v in g.extras.items()},
    )
