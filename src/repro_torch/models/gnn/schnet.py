"""SchNet (arXiv:1706.08566) — triplet-gather regime (distance-expanded
continuous-filter convolutions); aggregation and the per-graph readout
are sorted segment sums (the kernel on the card).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core.segments import sorted_segment_sum
from repro_torch.models.gnn import common as C


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    max_z: int = 100


def ssp(x):
    """Shifted softplus, SchNet's activation. F.softplus returns x itself
    above its threshold of 20, where jax.nn.softplus computes
    log1p(exp(x)); the two differ there by less than exp(-20), below
    float32's resolution at x > 20."""
    return F.softplus(x) - math.log(2.0)


def init_params(gen: torch.Generator | None, cfg: SchNetConfig, *,
                device=None) -> dict:
    """Seeded random weights drawn from `gen` on its device (`gen=None`:
    on `device`, e.g. "meta" for the shapes alone)."""
    d = cfg.d_hidden
    inter = []
    for _ in range(cfg.n_interactions):
        inter.append({
            "w_in": C.init_mlp(gen, [d, d], device=device),
            "filter": C.init_mlp(gen, [cfg.n_rbf, d, d], device=device),
            "w_out": C.init_mlp(gen, [d, d, d], device=device),
        })
    return {
        "embed": C.normal(gen, (cfg.max_z, d), 0.1, device),
        "inter": inter,
        "readout": C.init_mlp(gen, [d, d // 2, 1], device=device),
    }


def params_from_numpy(tree: dict, cfg: SchNetConfig, device=None) -> dict:
    """The reference's params (numpy leaves) on `device` (the card unless
    the caller passes another), bit for bit."""
    return C.tree_from_numpy(tree, init_params(None, cfg, device="meta"),
                             resolve_device(device))


def rbf_expand(dist: torch.Tensor, cfg: SchNetConfig) -> torch.Tensor:
    # torch.linspace and jnp.linspace may round a center an ulp apart
    centers = torch.linspace(0.0, cfg.cutoff, cfg.n_rbf, device=dist.device)
    gamma = 10.0 / cfg.cutoff
    return torch.exp(-gamma * (dist[:, None] - centers[None, :]) ** 2)


def apply(params: dict, g: C.GraphBatch, cfg: SchNetConfig, *,
          ranks=None) -> torch.Tensor:
    """Per-graph energies: (n_graphs,). With `ranks`, `g` holds this
    rank's slice of the edges and every node table whole (`common`'s
    edge cut)."""
    pos = g.extras["positions"]  # (N, 3)
    species = g.extras["species"]  # (N,) int32
    n = g.n_nodes
    x = params["embed"][species.clamp(0, cfg.max_z - 1)]
    d_ij = torch.linalg.vector_norm(pos[g.src] - pos[g.dst] + 1e-12, dim=-1)
    rbf = rbf_expand(d_ij, cfg)  # (E, n_rbf)
    for p in params["inter"]:
        filt = C.mlp(p["filter"], rbf, act=ssp, final_act=True)  # (E, D)
        msg = C.mlp(p["w_in"], x, act=ssp)[g.src] * filt  # cfconv
        agg = C.aggregate(msg, g.dst, n, g.edge_mask, ranks=ranks)
        x = x + C.mlp(p["w_out"], agg, act=ssp)
    atom_e = C.mlp(params["readout"], x, act=ssp)[:, 0]  # (N,)
    atom_e = torch.where(g.node_mask, atom_e, 0.0)
    n_graphs = g.extras["energy"].shape[0]  # static from the batch shape
    return sorted_segment_sum(atom_e, g.graph_ids, n_graphs)


def loss_fn(params, g: C.GraphBatch, cfg: SchNetConfig, *, ranks=None):
    energy = apply(params, g, cfg, ranks=ranks)
    target = g.extras["energy"]  # (n_graphs,)
    gmask = g.extras["graph_mask"]
    err = torch.where(gmask, (energy - target) ** 2, 0.0)
    return err.sum() / gmask.sum().clamp_min(1)
