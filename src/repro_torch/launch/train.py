"""Training launcher: `python -m repro_torch.launch.train --arch <id> [...]`.

Runs a REDUCED config of the selected LM architecture (`reduced_lm`) on
the card, or on the CPU with `--device cpu`: registry config → seeded
weights → train step → Trainer with checkpoints and restart, the same
flags and settings as `repro.launch.train` (AdamW lr 3e-4, warmup 10).
A rerun with the same `--ckpt-dir` resumes from its latest checkpoint.

Started as N ranks by a launcher, it trains across them on the mesh
`--mesh` (default the reference's data=1,model=N; e.g. data=2,model=2):
tensor / expert parallelism and sequence sharding on "model", the batch
and ZeRO-1 on "data"; NCCL between cards, gloo with `--device cpu`.
Rank 0 writes the checkpoints and prints:

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --device cpu --ckpt-dir build/ck2

Also holds `reduced_lm` and `reduced_gnn`, the cut-down configs that
`serve --mode lm`, the tests and the smoke run.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import os
import tempfile


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


def main(argv: list[str] | None = None) -> list[dict]:
    """Train, print the final loss, and return the Trainer's history (one
    dict of metrics a step)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="cuda (the default: a card) or cpu")
    ap.add_argument("--mesh", default=None,
                    help="under a launcher: data=D,model=M (default "
                    "data=1,model=WORLD_SIZE)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import resolve_device
    from repro_torch.configs.registry import ARCHS
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainSettings

    mod = importlib.import_module(ARCHS[args.arch])
    assert mod.FAMILY == "lm", "train.py drives LM archs; see examples/"
    cfg = reduced_lm(mod.CONFIG)
    ranks = specs = None
    if "WORLD_SIZE" in os.environ:
        from repro_torch.core.ranks import init_ranks

        sizes = parse_mesh(args.mesh, int(os.environ["WORLD_SIZE"]))
        ranks = init_ranks(device=args.device, axis_sizes=sizes,
                           axis_names=("data", "model"))
        dev = ranks.device
    else:
        dev = resolve_device(args.device)
    try:
        params = T.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg, ep=1 if ranks is None else sizes[1])
        if ranks is not None:
            specs = T.param_specs(cfg, False, sizes[1])
            params = T.shard_params(params, ranks, specs)
            if ranks.rank == 0:
                print(f"training over {ranks.world_size} ranks, mesh "
                      f"(data={sizes[0]}, model={sizes[1]}), backend "
                      f"{ranks.backend}", flush=True)
        opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=10,
                              total_steps=args.steps)
        step_fn = T.make_train_step(cfg, opt_cfg, ranks=ranks)
        pipe = TokenPipeline(vocab=cfg.vocab, batch=args.batch, seq=args.seq)
        tr = Trainer(
            step_fn, params, pipe, args.ckpt_dir,
            TrainSettings(total_steps=args.steps,
                          ckpt_every=args.ckpt_every),
            to_device=lambda b: {k: torch.from_numpy(v).to(dev)
                                 for k, v in b.items()},
            ranks=ranks, specs=specs,
        )
        tr.resume_if_possible()
        hist = tr.run()
        if ranks is None or ranks.rank == 0:
            print(f"final loss: {hist[-1]['loss']:.4f} "
                  f"(step {hist[-1]['step']})")
        return hist
    finally:
        if ranks is not None:
            ranks.close()


def parse_mesh(text: "str | None", world: int) -> tuple[int, int]:
    """(data, model) from "data=D,model=M"; the reference's (1, world)
    when `text` is None. The product must be the world size."""
    if text is None:
        return 1, world
    got = dict(part.split("=") for part in text.split(","))
    if set(got) != {"data", "model"}:
        raise SystemExit(f"--mesh {text!r}: give data=D,model=M")
    sizes = int(got["data"]), int(got["model"])
    if sizes[0] * sizes[1] != world:
        raise SystemExit(f"--mesh {text!r} does not hold the {world} ranks")
    return sizes


if __name__ == "__main__":
    main()
