"""DeepFM (arXiv:1703.04247): sparse embedding tables → FM interaction →
deep MLP. The embedding LOOKUP is the hot path: an EmbeddingBag built from
a clipped gather + the sorted segment sum (the kernel on the card).

One device: the reference's row-sharded table and its shuffle lookup
(`param_specs`, `make_sharded_lookup`) run across devices and are not
ported; a `lookup_fn(table, flat_ids) -> rows` of the caller's own may
still be passed.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.core.segments import sorted_segment_sum
from repro_torch.models.gnn.common import init_mlp, mlp, normal, tree_from_numpy


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


# ---------------------------------------------------------------------------
# EmbeddingBag
# ---------------------------------------------------------------------------

def embedding_bag_local(table: torch.Tensor, flat_ids: torch.Tensor,
                        bag_ids: torch.Tensor, n_bags: int) -> torch.Tensor:
    """Single-device EmbeddingBag: clipped gather + sorted segment sum
    (bag_ids sorted, int32 on the card)."""
    rows = table[flat_ids.clamp(0, table.shape[0] - 1)]
    return sorted_segment_sum(rows, bag_ids, n_bags)


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
        emb = lookup_fn(params["table"], flat)
        fm1 = lookup_fn(params["fm_w"], flat)
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
    The user tower is a handful of rows — always the local path.
    """
    emb_u, _ = _lookup(params, user_ids, cfg, None)
    u = emb_u[0].sum(dim=0)  # (D,)
    b, f = cand_ids.shape
    flat = _flat_ids(cand_ids, cfg)
    if lookup_fn is None:
        rows = params["table"][flat.clamp(0, cfg.total_rows - 1)]
    else:
        rows = lookup_fn(params["table"], flat)
    items = rows.reshape(b, f, cfg.embed_dim).sum(dim=1)  # (n_cand, D)
    return items @ u
