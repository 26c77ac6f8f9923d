"""Node gather / scatter across ranks via the MapSQ shuffle.

With the node dim sharded over the ranks (rank r holds the contiguous row
block [r n_loc, (r + 1) n_loc) of every node table) and the edges cut
into contiguous slices, `x[src]` and the sum of messages into `dst` are
the paper's join: requests are sorted by owner rank, shipped over one
all-to-all, served locally, and shipped back (Map → Sort → Shuffle →
Reduce). Per-rank traffic is O(E_local · d), never O(N · d).

The graph is static, so each route is planned once per graph, on the
host, when the graph is sharded (`data.graphs.shard_graph`): exact
per-(sender, owner) counts give uneven exchanges that carry every
request. Nothing is dropped, where the reference sizes each owner's
bucket at 2x the uniform share and drops the overflow (ROADMAP Queue 3:
a dst-sorted edge slice sends most of its messages to one or two
owners). A forward makes no host sync: the plans hold the counts as
host ints and the index arrays on the device, and every layer (and the
backward) reuses them.

  * gather: the owner already knows, from the plan, which of its rows
    each sender asks for, so ids need not travel: one exchange returns
    the rows, and the sender puts them back in edge order.
  * scatter: each sender's messages travel in owner order, and each
    sender's run arrives dst-ascending (its edge slice is dst-sorted and
    the route sort is stable). The plan's `merge` permutation orders the
    received rows by local dst, stably, so rows of one node keep their
    global edge order, and one sorted segment sum (the segment_reduce
    kernel on the card) reduces them: one launch per aggregation per
    rank, the sum in the plain path's order.

Gradients are exact: the exchanges' backward is the reverse exchange, an
index's the scatter-add, a sorted segment sum's the gather.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import distributed as D
from repro_torch.core.segments import sorted_segment_sum


@dataclasses.dataclass
class GatherRoute:
    """One rank's plan to read rows of a node table for its edge slice.

    recv_local: (n_recv,) local rows this rank serves, in received order
    (sender-major); inv: (n_edges,) where each local edge's row lands in
    the rows returned in owner order; the counts are host ints."""
    group: Any
    recv_local: torch.Tensor
    inv: torch.Tensor
    send_counts: list[int]
    recv_counts: list[int]


@dataclasses.dataclass
class ScatterRoute:
    """One rank's plan to sum its edge slice's messages into the owners.

    send: (n_send,) local edge positions in send order (owner-major,
    stable; masked and out-of-range edges left out); merge: (n_recv,)
    the received rows in order of their local dst (stable); seg_ids:
    (n_recv,) int32, those local dst ids, ascending; n_local: this rank's
    node count."""
    group: Any
    send: torch.Tensor
    merge: torch.Tensor
    seg_ids: torch.Tensor
    send_counts: list[int]
    recv_counts: list[int]
    n_local: int


def gather_nodes(x_local: torch.Tensor, route: GatherRoute) -> torch.Tensor:
    """x_global[ids] for this rank's edge slice: (n_edges, d), from the
    node table's row block on each rank (x_local: (n_loc, d))."""
    rows = x_local[route.recv_local]
    back = D.exchange(rows, route.group, route.recv_counts, route.send_counts)
    return back[route.inv]


def scatter_add_nodes(msgs: torch.Tensor, route: ScatterRoute) -> torch.Tensor:
    """The sum of every rank's edge messages into this rank's nodes:
    (n_edges, d) edge-sliced -> (n_loc, d). Masked edges are not sent."""
    sent = D.exchange(msgs[route.send], route.group, route.send_counts,
                      route.recv_counts)
    return sorted_segment_sum(sent[route.merge], route.seg_ids, route.n_local)


# -- planning on the host -----------------------------------------------------


def _slices(a: np.ndarray, ndev: int, chunks: int) -> np.ndarray:
    """(E,) -> (ndev, chunks, E / (ndev chunks)): rank s's chunk c."""
    if a.shape[0] % (ndev * chunks):
        raise ValueError(f"{a.shape[0]} edges do not split into {ndev} "
                         f"ranks x {chunks} chunks")
    return a.reshape(ndev, chunks, -1)


def _counts(owner: np.ndarray, ndev: int) -> list[int]:
    return np.bincount(owner, minlength=ndev).astype(np.int64).tolist()


def plan_gather(ids: np.ndarray, n_nodes: int, ndev: int, rank: int,
                group, device, chunks: int = 1) -> list[GatherRoute]:
    """The routes of `ids` (the whole graph's (E,) index array into a node
    table of `n_nodes` rows) for rank `rank`, one per chunk of its edge
    slice. Every edge is routed (padding edges too, as `x[ids]` reads
    them); an id outside the table raises."""
    ids = np.asarray(ids, np.int64)
    if ids.size and (ids.min() < 0 or ids.max() >= n_nodes):
        raise ValueError(f"ids outside the {n_nodes}-row node table")
    n_loc = n_nodes // ndev
    routes = []
    cut = _slices(ids, ndev, chunks)
    for c in range(chunks):
        sub = cut[:, c]  # (ndev, C): every sender's chunk c
        owner = sub // n_loc
        order = np.argsort(owner[rank], kind="stable")
        inv = np.empty_like(order)
        inv[order] = np.arange(order.shape[0])
        mine = owner == rank  # sender-major: what each sender asks here
        routes.append(GatherRoute(
            group=group,
            recv_local=_t(sub[mine] - rank * n_loc, device),
            inv=_t(inv, device),
            send_counts=_counts(owner[rank], ndev),
            recv_counts=mine.sum(axis=1).tolist()))
    return routes


def plan_scatter(dst: np.ndarray, valid: np.ndarray, n_nodes: int,
                 ndev: int, rank: int, group, device,
                 chunks: int = 1) -> list[ScatterRoute]:
    """The routes of messages into `dst` (the whole graph's (E,) dst ids
    into a table of `n_nodes` rows; `valid` the edge mask) for rank
    `rank`, one per chunk of its edge slice. Masked edges and ids outside
    the table are left out, as the plain aggregate drops them."""
    dst = np.asarray(dst, np.int64)
    keep = np.asarray(valid, bool) & (dst >= 0) & (dst < n_nodes)
    n_loc = n_nodes // ndev
    routes = []
    cut, kept = _slices(dst, ndev, chunks), _slices(keep, ndev, chunks)
    for c in range(chunks):
        sub, ok = cut[:, c], kept[:, c]
        owner = np.where(ok, sub // n_loc, ndev)
        mine = owner == rank
        local = sub[mine] - rank * n_loc  # sender-major runs
        merge = np.argsort(local, kind="stable")
        send = np.nonzero(ok[rank])[0]
        send = send[np.argsort(owner[rank][send], kind="stable")]
        routes.append(ScatterRoute(
            group=group,
            send=_t(send, device),
            merge=_t(merge, device),
            seg_ids=_t(local[merge], device, torch.int32),
            send_counts=_counts(owner[rank][send], ndev),
            recv_counts=mine.sum(axis=1).tolist(),
            n_local=n_loc))
    return routes


def _t(a: np.ndarray, device, dtype=torch.int64) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


@dataclasses.dataclass
class EdgeRoutes:
    """The routes of one edge set on this rank: gathers of the src and
    dst tables and the scatter into dst, each a list of one route per
    chunk of the rank's edge slice (one chunk unless the set is
    streamed)."""
    src: list[GatherRoute]
    dst: list[GatherRoute]
    scatter: list[ScatterRoute]


def plan_edges(src: np.ndarray, dst: np.ndarray, valid: np.ndarray,
               n_src: int, n_dst: int, ranks, axes: tuple[str, ...],
               chunks: int = 1) -> EdgeRoutes:
    """Every route of one edge set (whole-graph arrays) for this rank of
    the group over `axes` of `ranks`."""
    ndev, rank = ranks.axis_size(axes), ranks.axis_index(axes)
    group, dev = ranks.group(axes), ranks.device
    return EdgeRoutes(
        src=plan_gather(src, n_src, ndev, rank, group, dev, chunks),
        dst=plan_gather(dst, n_dst, ndev, rank, group, dev, chunks),
        scatter=plan_scatter(dst, valid, n_dst, ndev, rank, group, dev,
                             chunks))
