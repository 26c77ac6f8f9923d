"""DeepFM (arXiv:1703.04247): sparse embedding tables → FM interaction →
deep MLP. The embedding LOOKUP is the hot path: an EmbeddingBag built from
a clipped gather + the sorted segment sum (the kernel on the card).

Across ranks the table is row-sharded over the "model" axis
(`param_specs`, `shard_params`) and the lookup is the MapSQ shuffle
(`make_sharded_lookup`): each id goes to the rank that owns its row, the
row is gathered there and sent back, one exchange each way. The lookup
always returns `table[ids]`: the exchanges are sized exactly from the
per-rank counts (exchanged first), so nothing overflows and nothing is
dropped, where the reference's fixed `cap` returns zero rows past it.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import torch

from repro_torch import resolve_device
from repro_torch.core import distributed as D
from repro_torch.core.segments import sorted_segment_sum
from repro_torch.models.gnn.common import init_mlp, mlp, normal, tree_from_numpy

if TYPE_CHECKING:
    from repro_torch.core.ranks import RankContext

# the mesh axis the table's rows shard over (the reference's "model")
TABLE_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class DeepFMConfig:
    n_sparse: int = 39
    embed_dim: int = 10
    mlp_dims: tuple[int, ...] = (400, 400, 400)
    rows_per_field: int = 860_000  # ~33.5M rows total (Criteo-scale)
    n_item_fields: int = 3  # retrieval: fields forming the item tower
    shuffle_capacity_factor: float = 1.5

    @property
    def total_rows(self) -> int:
        return self.n_sparse * self.rows_per_field


def init_params(gen: torch.Generator | None, cfg: DeepFMConfig, *,
                device=None) -> dict:
    """Seeded random weights drawn from `gen` on its device (`gen=None`:
    on `device`, e.g. "meta" for the shapes alone)."""
    d_in = cfg.n_sparse * cfg.embed_dim
    table = normal(gen, (cfg.total_rows, cfg.embed_dim), 0.01, device)
    return {
        "table": table,
        "fm_w": normal(gen, (cfg.total_rows, 1), 0.01, device),
        "mlp": init_mlp(gen, [d_in, *cfg.mlp_dims, 1], device=device),
        "bias": torch.zeros((), device=table.device),
    }


def params_from_numpy(tree: dict, cfg: DeepFMConfig, device=None) -> dict:
    """The reference's params (numpy leaves) on `device` (the card unless
    the caller passes another), bit for bit."""
    return tree_from_numpy(tree, init_params(None, cfg, device="meta"),
                           resolve_device(device))


def param_specs(cfg: DeepFMConfig) -> dict:
    """Each leaf's mesh axis per dim (the reference's PartitionSpecs as
    tuples): the tables row-sharded over "model", the rest replicated."""
    return {
        "table": (TABLE_AXIS, None),  # row-sharded: the huge array
        "fm_w": (TABLE_AXIS, None),
        "mlp": [{"w": (None, None), "b": (None,)} for _ in
                range(len(cfg.mlp_dims) + 1)],
        "bias": (),
    }


def shard_params(params: dict, ranks: "RankContext",
                 cfg: DeepFMConfig) -> dict:
    """Whole params as this rank's, by `param_specs`: the rows of the
    tables that its coordinate on "model" owns (a contiguous block of
    total_rows / model rows), every other leaf as it is."""
    n, r = ranks.axis_size(TABLE_AXIS), ranks.axis_index(TABLE_AXIS)
    specs = param_specs(cfg)

    def cut(a, spec):
        if isinstance(spec, list):
            return [cut(x, s) for x, s in zip(a, spec)]
        if isinstance(spec, dict):
            return {k: cut(a[k], spec[k]) for k in spec}
        if spec and spec[0] == TABLE_AXIS:
            if a.shape[0] % n:
                raise ValueError(f"{a.shape[0]} rows do not split over {n} "
                                 "ranks")
            rows = a.shape[0] // n
            return a[r * rows:(r + 1) * rows]
        return a

    return cut(params, specs)


# ---------------------------------------------------------------------------
# EmbeddingBag
# ---------------------------------------------------------------------------

def embedding_bag_local(table: torch.Tensor, flat_ids: torch.Tensor,
                        bag_ids: torch.Tensor, n_bags: int) -> torch.Tensor:
    """Single-device EmbeddingBag: clipped gather + sorted segment sum
    (bag_ids sorted, int32 on the card)."""
    rows = table[flat_ids.clamp(0, table.shape[0] - 1)]
    return sorted_segment_sum(rows, bag_ids, n_bags)


def _sharded_lookup_local(tables, ids: torch.Tensor, *,
                          ranks: "RankContext", meta_cap: "int | None" = None):
    """This rank's part of the sharded lookup: route each of its ids to
    the rank that owns the row, gather there, route the rows back.

    tables: a tuple of this rank's row blocks (rows [r R_local, (r + 1)
    R_local) of each table; DeepFM's forward passes the table and fm_w,
    read in one route); ids: (n,), this rank's slice of the flattened id
    stream, clipped to the tables as the local path clips. Returns a
    tuple of (n, D_t) = table_t[ids], exactly. Per-rank counts are
    exchanged first and read on the host (one sync a call), so both
    exchanges move exactly the rows there are; every table's rows travel
    back in one exchange. Their backward is the reverse exchange, and
    each table's gradient the scatter-add of its rows' gradients.

    On meta tensors (a traced step: no counts to read) every rank sends
    and receives `meta_cap` ids per owner, the reference's bucket
    capacity; without it a meta lookup raises.
    """
    ep, er = ranks.axis_size(TABLE_AXIS), ranks.axis_index(TABLE_AXIS)
    group = ranks.group(TABLE_AXIS)
    r_local = tables[0].shape[0]
    flat = ids.reshape(-1).long().clamp(0, ep * r_local - 1)
    owner = torch.div(flat, r_local, rounding_mode="floor")
    order = torch.sort(owner, stable=True).indices
    if ids.device.type == "meta":
        if meta_cap is None:
            raise ValueError("a lookup on meta tensors needs its per-owner "
                             "counts (meta_cap)")
        counts = [[meta_cap] * ep] * 2
        send = flat.new_empty(ep * meta_cap)
    else:
        send_counts = torch.bincount(owner, minlength=ep)
        recv_counts = D.exchange(send_counts, group)
        counts = torch.stack([send_counts, recv_counts]).tolist()
        send = flat[order]
    want = D.exchange(send, group, counts[0], counts[1])
    local = want - er * r_local
    rows = torch.cat([t[local] for t in tables], dim=1)
    back = D.exchange(rows, group, counts[1], counts[0])
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return back[inv].split([t.shape[1] for t in tables], dim=1)


def make_sharded_lookup(ranks: "RankContext", meta_cap: "int | None" = None):
    """lookup_fn(tables, flat_ids) -> (rows of each table) for `forward`,
    `bce_loss` and `retrieval_scores`: the tables row-sharded over the
    "model" axis of `ranks` (`shard_params`), each rank passing its own
    slice of the id stream. `meta_cap`: the ids per owner of a lookup on
    meta tensors (see `_sharded_lookup_local`)."""
    def lookup(tables, flat_ids):
        return _sharded_lookup_local(tables, flat_ids, ranks=ranks,
                                     meta_cap=meta_cap)

    return lookup


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def _flat_ids(ids: torch.Tensor, cfg: DeepFMConfig) -> torch.Tensor:
    """(B, F) field-offset-free ids -> (B * F,) table rows, int32."""
    f = ids.shape[1]
    offsets = torch.arange(f, dtype=torch.int32, device=ids.device)
    return (ids + offsets[None] * cfg.rows_per_field).reshape(-1)


def _lookup(params, ids, cfg, lookup_fn):
    """ids: (B, F) field-offset-free ids in [0, rows_per_field). Returns
    (emb (B, F, D), fm1 (B, F))."""
    b, f = ids.shape
    flat = _flat_ids(ids, cfg)
    if lookup_fn is None:
        bags = torch.arange(flat.shape[0], dtype=torch.int32,
                            device=flat.device)
        emb = embedding_bag_local(params["table"], flat, bags, flat.shape[0])
        fm1 = embedding_bag_local(params["fm_w"], flat, bags, flat.shape[0])
    else:
        emb, fm1 = lookup_fn((params["table"], params["fm_w"]), flat)
    return emb.reshape(b, f, cfg.embed_dim), fm1.reshape(b, f)


def forward(params: dict, ids: torch.Tensor, cfg: DeepFMConfig,
            lookup_fn=None) -> torch.Tensor:
    """CTR logits (B,). ids: (B, n_sparse) int32."""
    emb, fm1 = _lookup(params, ids, cfg, lookup_fn)
    # FM second order: 0.5 * ((Σv)² − Σv²), summed over embed dim
    s = emb.sum(dim=1)
    fm2 = 0.5 * (s * s - (emb * emb).sum(dim=1)).sum(dim=-1)
    deep = mlp(params["mlp"], emb.reshape(emb.shape[0], -1))[:, 0]
    return params["bias"] + fm1.sum(dim=1) + fm2 + deep


def bce_loss(params, ids, labels, cfg, lookup_fn=None):
    logits = forward(params, ids, cfg, lookup_fn)
    return (logits.clamp_min(0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def retrieval_scores(params: dict, user_ids: torch.Tensor,
                     cand_ids: torch.Tensor, cfg: DeepFMConfig,
                     lookup_fn=None) -> torch.Tensor:
    """Score 1 query against n_candidates items: batched dot, not a loop.

    user_ids: (1, n_sparse); cand_ids: (n_cand, n_item_fields).
    Item tower = sum of item-field embeddings; score = item · user.
    The user tower is a handful of rows: the local path, or with a
    sharded table (`lookup_fn` of `make_sharded_lookup`) the same lookup,
    since this rank holds only its rows.
    """
    if lookup_fn is None:
        emb_u, _ = _lookup(params, user_ids, cfg, None)
    else:
        (emb_u,) = lookup_fn((params["table"],), _flat_ids(user_ids, cfg))
    u = emb_u.reshape(-1, cfg.embed_dim).sum(dim=0)  # (D,)
    b, f = cand_ids.shape
    flat = _flat_ids(cand_ids, cfg)
    if lookup_fn is None:
        rows = params["table"][flat.clamp(0, cfg.total_rows - 1)]
    else:
        (rows,) = lookup_fn((params["table"],), flat)
    items = rows.reshape(b, f, cfg.embed_dim).sum(dim=1)  # (n_cand, D)
    return items @ u
