"""Training launcher (to come): for now only `reduced_lm` and
`reduced_gnn`, the cut-down configs that `serve --mode lm`, the tests and
the smoke run. The launcher's `main`
(registry config → jitted step → Trainer with checkpoints) comes with the
training slice of the port."""
from __future__ import annotations

import dataclasses


def reduced_lm(cfg, vocab=512):
    return dataclasses.replace(
        cfg, n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4), d_head=16,
        d_ff=min(cfg.d_ff, 128), vocab=vocab,
        n_experts=min(cfg.n_experts, 8) if cfg.is_moe else 0,
        top_k=min(cfg.top_k, 2) if cfg.is_moe else 0,
        d_expert_ff=min(cfg.d_expert_ff, 64) if cfg.is_moe else 0,
        sliding_window=min(cfg.sliding_window, 8) if cfg.sliding_window
        else 0, kv_chunk=16, fsdp=False,
    )


def reduced_gnn(arch: str, cfg):
    """The reduced config of a GNN arch that the archs' smoke tests run
    (any config dataclass of the arch: the reference's or this port's)."""
    changes = {"schnet": dict(n_interactions=2, d_hidden=16, n_rbf=8),
               "graphcast": dict(n_layers=2, d_hidden=16, n_vars=6),
               "gat-cora": dict(d_in=12, n_classes=3),
               "meshgraphnet": dict(n_layers=2, d_hidden=16, d_node_in=8)}
    return dataclasses.replace(cfg, **changes[arch])
