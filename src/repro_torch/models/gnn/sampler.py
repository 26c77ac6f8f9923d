"""Real neighbor sampler for minibatch_lg (fanout 15-10), host-side.

CSR adjacency built once; per-batch GraphSAGE-style layered sampling with a
deterministic np.random.Generator (its state is part of the data-pipeline
checkpoint). Output is a static-shape padded GraphBatch: capacity =
batch * (1 + f1 + f1*f2) nodes, batch * (f1 + f1*f2) edges, dst-sorted.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray  # (N+1,)
    indices: np.ndarray  # (E,)

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @classmethod
    def from_edges(cls, src: np.ndarray, dst: np.ndarray, n_nodes: int):
        """CSR over incoming edges: row v lists the neighbors that message v."""
        order = np.argsort(dst, kind="stable")
        dst_s = dst[order]
        indptr = np.zeros(n_nodes + 1, np.int64)
        np.add.at(indptr, dst_s + 1, 1)
        indptr = np.cumsum(indptr)
        return cls(indptr=indptr, indices=src[order].astype(np.int32))


def sample_block(
    g: CSRGraph,
    seeds: np.ndarray,
    fanouts: list[int],
    rng: np.random.Generator,
):
    """Layered fanout sampling (with replacement, GraphSAGE-style).

    Returns (nodes, src, dst, edge_mask) where src/dst index into `nodes`
    (position-based ids), edges are sorted by dst, and padded entries point
    at the sentinel slot len(nodes)-1 with edge_mask False.
    """
    frontier = seeds.astype(np.int32)
    all_nodes = [frontier]
    e_src, e_dst = [], []
    offset = 0  # position of the current frontier inside all_nodes
    for f in fanouts:
        deg = g.indptr[frontier + 1] - g.indptr[frontier]
        picks = rng.integers(
            0, np.maximum(deg, 1)[:, None], size=(len(frontier), f)
        )
        nbr = g.indices[
            np.minimum(g.indptr[frontier, None] + picks,
                       len(g.indices) - 1)
        ].astype(np.int32)
        has_deg = deg > 0
        nbr = np.where(has_deg[:, None], nbr, frontier[:, None])  # self-loop
        new_pos = offset + len(frontier) + np.arange(nbr.size, dtype=np.int32)
        # edge: sampled neighbor (child layer) -> frontier node
        e_src.append(new_pos)
        e_dst.append(np.repeat(offset + np.arange(len(frontier),
                                                  dtype=np.int32), f))
        all_nodes.append(nbr.reshape(-1))
        offset += len(frontier)
        frontier = nbr.reshape(-1)
    nodes = np.concatenate(all_nodes)
    src = np.concatenate(e_src)
    dst = np.concatenate(e_dst)
    order = np.argsort(dst, kind="stable")  # the Sort phase, host-side
    return nodes, src[order], dst[order], np.ones(len(src), bool)


def block_capacity(batch: int, fanouts: list[int]) -> tuple[int, int]:
    n, e, layer = batch, 0, batch
    for f in fanouts:
        e += layer * f
        layer *= f
        n += layer
    return n, e
