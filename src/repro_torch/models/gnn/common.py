"""Shared GNN machinery: padded static-shape graph batches, MLPs, and
message passing built on `repro_torch.core.segments` / the segment_reduce
kernel.

Aggregation is edge-index gathers + a sorted segment sum over dst-sorted
edges: exactly the MapSQ reduce with node ids as join keys. On a CUDA
tensor every sorted aggregation launches `kernels.segment_reduce`.

Node sharding: with `node_spec` (the mesh axes the node dim shards over)
and a rank context `ranks`, each rank holds the row block of every node
table and a contiguous slice of every edge set (`data.graphs.
shard_graph`). The node ops then do what GSPMD does for the reference,
or, with the shuffle, route through `models/gnn/distributed.py`:

  * take_nodes — all-gather the node table and index it; with the
    shuffle, the owners serve the rows over one exchange;
  * aggregate — a local sorted sum over every node, then a
    reduce-scatter; with the shuffle (`aggregate_nodes`), the messages
    go to their owners and one sorted sum reduces them there.

Edge cut: with a rank context of more than one rank and no `node_spec`
(the reference's cells of every graph under a million nodes), each rank
holds a contiguous slice of every edge set and every node table whole.
Each aggregation sums this rank's edges into every node, then an
all-reduce over every axis adds the ranks' parts (GSPMD's psum in the
reference); `take_nodes` indexes the whole table. Every rank then holds
the same node tensors and computes the same loss.

Without a rank context (or at one rank) the node dim is whole, and
`node_spec` and the shuffle are the plain path, as the reference on a
(1, 1) mesh.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import distributed as D
from repro_torch.core.segments import (
    _take_clamped, segment_max, segment_softmax, segment_sum,
    sorted_segment_sum,
)
from repro_torch.models.gnn.distributed import gather_nodes, scatter_add_nodes


class GraphBatch(NamedTuple):
    """Static-shape (padded) graph. Edges are SORTED BY dst at build time.

    node_feat: (N, F) float; src/dst: (E,) int32; edge_mask: (E,) bool;
    node_mask: (N,) bool; graph_ids: (N,) int32 (molecule batching; 0 for
    single graphs); extras: arch-specific arrays (positions for schnet,
    mesh graphs for graphcast, ...).
    """

    node_feat: Any
    src: Any
    dst: Any
    node_mask: Any
    edge_mask: Any
    graph_ids: Any
    extras: dict[str, Any]

    @property
    def n_nodes(self) -> int:
        return self.node_feat.shape[0]

    @property
    def n_edges(self) -> int:
        return self.src.shape[0]


def _sharded(node_spec: tuple[str, ...], ranks) -> bool:
    return bool(node_spec) and ranks is not None


def edge_group(node_spec: tuple[str, ...], ranks):
    """The world group when the edges are cut over every rank and the
    node tables whole (ranks of more than one rank, no `node_spec`),
    else None."""
    if node_spec or ranks is None or ranks.world_size == 1:
        return None
    return ranks.group(tuple(ranks.mesh.axis_names))


def aggregate(messages: torch.Tensor, dst: torch.Tensor, n_nodes: int,
              edge_mask: torch.Tensor | None = None,
              sorted_edges: bool = True,
              node_spec: tuple[str, ...] = (), *,
              ranks=None) -> torch.Tensor:
    """Sum messages into destination nodes (the MapSQ reduce).

    dst must be sorted ascending when sorted_edges=True (our pipelines sort
    at load time): the sorted segment sum, the kernel on the card. With
    sorted_edges=False, a plain scatter-add. Ids outside the node table
    drop out.

    Node-sharded (`node_spec` and `ranks`): `messages` / `dst` are this
    rank's edge slice with global dst ids and `n_nodes` this rank's row
    block; every rank sums its messages over every node, and a
    reduce-scatter leaves each rank its block's sums. Edge-cut (`ranks`
    without `node_spec`): this rank's edge slice summed into every node,
    then all-reduced.
    """
    if edge_mask is not None:
        messages = torch.where(edge_mask[:, None], messages, 0)
    n_sum = n_nodes
    if _sharded(node_spec, ranks):
        n_sum = n_nodes * ranks.axis_size(node_spec)
    if sorted_edges:
        out = sorted_segment_sum(messages, dst, n_sum)
    else:
        out = segment_sum(messages, dst, n_sum)
    if n_sum != n_nodes:
        out = D.reduce_scatter_rows(out, ranks.group(node_spec))
    group = edge_group(node_spec, ranks)
    if group is not None:
        out = D.all_reduce_sum(out, group)
    return constrain_nodes(out, node_spec)


def constrain_nodes(x: torch.Tensor, node_spec: tuple[str, ...]) -> torch.Tensor:
    """Shard dim 0 (nodes) over `node_spec` axes: the reference's sharding
    constraint. A node-sharded rank holds its row block already, so this
    is the identity."""
    return x


def edge_routes(g: GraphBatch, name: str, node_spec, shuffle: bool, ranks):
    """The shuffle's routes of edge set `name` on this rank, planned when
    the graph was sharded (`data.graphs.shard_graph`); None off the
    shuffle."""
    if not (shuffle and _sharded(node_spec, ranks)):
        return None
    return g.extras["routes"][name]


def take_nodes(x: torch.Tensor, ids: torch.Tensor, edge_mask: torch.Tensor,
               node_spec: tuple[str, ...] = (),
               shuffle: bool = False, *, ranks=None,
               route=None) -> torch.Tensor:
    """x[ids]. Node-sharded (`node_spec` and `ranks`; x this rank's row
    block, ids global): the node table all-gathered and indexed, or with
    `shuffle` the rows served by their owners along `route` (a
    `distributed.GatherRoute` of these ids)."""
    if not _sharded(node_spec, ranks):
        return x[ids]
    if shuffle:
        return gather_nodes(x, route)
    return D.all_gather_rows(x, ranks.group(node_spec))[ids]


def aggregate_nodes(messages: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                    edge_mask: torch.Tensor,
                    node_spec: tuple[str, ...] = (),
                    shuffle: bool = False, *, ranks=None,
                    route=None) -> torch.Tensor:
    """aggregate() that can route through the shuffle scatter instead (same
    contract): node-sharded with `shuffle`, the messages go to the owners
    of their dst along `route` (a `distributed.ScatterRoute`)."""
    if shuffle and _sharded(node_spec, ranks):
        return scatter_add_nodes(
            torch.where(edge_mask[:, None], messages, 0), route)
    return aggregate(messages, dst, n_nodes, edge_mask, node_spec=node_spec,
                     ranks=ranks)


def aggregate_softmax(scores: torch.Tensor, values: torch.Tensor,
                      dst: torch.Tensor, n_nodes: int,
                      edge_mask: torch.Tensor, *, ranks=None) -> torch.Tensor:
    """Attention aggregation (GAT): segment softmax over incoming edges,
    then weighted sum. scores: (E, H); values: (E, H, D) -> (N, H, D).
    Every head at once: the segment ops treat each column on its own, so
    the weighted sum is one sorted segment sum of width H * D. Edge-cut
    (`ranks`; see `aggregate`): the softmax's max over every rank's
    edges (an all-reduce, no gradient: it only shifts) and its sum, then
    the weighted sums, are all-reduced."""
    scores = torch.where(edge_mask[:, None], scores, -1e30)
    group = edge_group((), ranks)
    if group is None:
        a = segment_softmax(scores, dst, n_nodes)
    else:
        mx = D.all_reduce_max(segment_max(scores, dst, n_nodes), group)
        mx = torch.where(torch.isfinite(mx), mx, 0.0)
        expd = torch.exp(scores - _take_clamped(mx, dst))
        total = D.all_reduce_sum(segment_sum(expd, dst, n_nodes), group)
        a = expd / _take_clamped(total, dst).clamp_min(1e-30)
    a = torch.where(edge_mask[:, None], a, 0.0)
    out = sorted_segment_sum(values * a[:, :, None], dst, n_nodes)
    return out if group is None else D.all_reduce_sum(out, group)


def remat(fn, on: bool):
    """`fn` rematerialized in the backward when `on` (the reference's
    `jax.checkpoint`): a forward that records a gradient keeps only the
    call's inputs and runs `fn` again in the backward, sorted segment sums
    included. Without a gradient (serving) `fn` runs as it is."""
    if not on:
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False)

    return run


# ---------------------------------------------------------------------------
# Tiny NN toolbox
# ---------------------------------------------------------------------------

def normal(gen: torch.Generator | None, shape, std: float,
           device=None) -> torch.Tensor:
    """A float32 normal times `std`, drawn from `gen` on its device (or, when
    `gen` is None, from torch's default generator on `device`; "meta":
    the shape alone)."""
    dev = gen.device if gen is not None else device
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=dev) * std


def init_mlp(gen: torch.Generator | None, sizes: list[int],
             dtype=torch.float32, device=None) -> list[dict]:
    ps = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = normal(gen, (a, b), a**-0.5, device)
        ps.append({"w": w.to(dtype), "b": torch.zeros((b,), dtype=dtype,
                                                       device=w.device)})
    return ps


def _linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    """x @ w + b in the promoted type of x and the weights, as JAX promotes
    (bfloat16 activations against float32 weights compute in float32)."""
    dt = torch.promote_types(x.dtype, p["w"].dtype)
    return x.to(dt) @ p["w"].to(dt) + p["b"]


def mlp(ps: list[dict], x: torch.Tensor, act=F.relu,
        final_act: bool = False) -> torch.Tensor:
    for i, p in enumerate(ps):
        x = _linear(x, p)
        if i < len(ps) - 1 or final_act:
            x = act(x)
    return x


def layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """In float32, no affine; the population variance (jnp.var), which
    torch.var gives only with correction=0."""
    x32 = x.float()
    m = x32.mean(dim=-1, keepdim=True)
    v = x32.var(dim=-1, keepdim=True, correction=0)
    return (x32 - m) * torch.rsqrt(v + eps)


def mse_loss(pred: torch.Tensor, target: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    err = torch.where(mask[:, None], (pred - target) ** 2, 0.0)
    return err.sum() / (mask.sum() * pred.shape[-1]).clamp_min(1)


def masked_ce(logits: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    nll = torch.where(mask, lse - ll, 0.0)
    return nll.sum() / mask.sum().clamp_min(1)


# ---------------------------------------------------------------------------
# Weights from the reference
# ---------------------------------------------------------------------------

def tree_from_numpy(tree, like, device, path: str = "params"):
    """The reference's params as numpy arrays (`jax.tree.map(np.asarray,
    params)`) as this port's on `device`: `like` is the port's params of
    the same config (shapes only, e.g. on "meta"). The same nested
    dict / list structure and shapes, every leaf bit for bit; a key,
    length or shape that differs raises."""
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{path}: keys {got}, expected {sorted(like)}")
        return {k: tree_from_numpy(tree[k], v, device, f"{path}/{k}")
                for k, v in like.items()}
    if isinstance(like, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(like):
            raise ValueError(f"{path}: expected a list of {len(like)}")
        return [tree_from_numpy(t, v, device, f"{path}[{i}]")
                for i, (t, v) in enumerate(zip(tree, like))]
    arr = np.array(tree, copy=True, order="C")  # writable, owned by torch
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{path}: shape {arr.shape}, expected "
                         f"{tuple(like.shape)}")
    return torch.from_numpy(arr).to(device)
