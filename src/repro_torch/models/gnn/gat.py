"""GAT (Velickovic et al., arXiv:1710.10903) — SDDMM/SpMM regime.

Edge attention = per-edge score (SDDMM analogue via gathers), segment
softmax over dst (sorted; the MapSQ reduce), weighted segment sum (SpMM:
the sorted segment sum, the kernel on the card).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models.gnn import common as C


@dataclasses.dataclass(frozen=True)
class GATConfig:
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    n_classes: int = 7
    d_in: int = 1433
    negative_slope: float = 0.2


def init_params(gen: torch.Generator | None, cfg: GATConfig, *,
                device=None) -> dict:
    """Seeded random weights drawn from `gen` on its device (`gen=None`:
    on `device`, e.g. "meta" for the shapes alone)."""
    layers = []
    d_in = cfg.d_in
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        h = 1 if last else cfg.n_heads
        d_out = cfg.n_classes if last else cfg.d_hidden
        w = C.normal(gen, (d_in, h, d_out), d_in**-0.5, device)
        layers.append({
            "w": w,
            "a_src": C.normal(gen, (h, d_out), d_out**-0.5, device),
            "a_dst": C.normal(gen, (h, d_out), d_out**-0.5, device),
            "b": torch.zeros((h, d_out), device=w.device),
        })
        d_in = d_out * h if not last else d_out
    return {"layers": layers}


def params_from_numpy(tree: dict, cfg: GATConfig, device=None) -> dict:
    """The reference's params (numpy leaves) on `device` (the card unless
    the caller passes another), bit for bit."""
    return C.tree_from_numpy(tree, init_params(None, cfg, device="meta"),
                             resolve_device(device))


def apply(params: dict, g: C.GraphBatch, cfg: GATConfig, *,
          ranks=None) -> torch.Tensor:
    """Node logits (N, C). With `ranks`, `g` holds this rank's slice of
    the edges and every node table whole (`common`'s edge cut)."""
    x = g.node_feat
    n = g.n_nodes
    for i, p in enumerate(params["layers"]):
        last = i == len(params["layers"]) - 1
        h = torch.einsum("nf,fhd->nhd", x, p["w"])  # (N, H, D)
        s_src = torch.einsum("nhd,hd->nh", h, p["a_src"])
        s_dst = torch.einsum("nhd,hd->nh", h, p["a_dst"])
        scores = F.leaky_relu(s_src[g.src] + s_dst[g.dst],
                              cfg.negative_slope)  # (E, H)
        agg = C.aggregate_softmax(scores, h[g.src], g.dst, n, g.edge_mask,
                                  ranks=ranks)
        agg = agg + p["b"][None]
        if last:
            x = agg.mean(dim=1)  # average heads -> (N, C)
        else:
            x = F.elu(agg).reshape(n, -1)  # concat heads
        x = torch.where(g.node_mask[:, None], x, 0)
    return x


def loss_fn(params, g: C.GraphBatch, cfg: GATConfig, *, ranks=None):
    logits = apply(params, g, cfg, ranks=ranks)
    labels = g.extras["labels"]
    mask = g.extras["train_mask"] & g.node_mask
    return C.masked_ce(logits, labels, mask)
