"""Serving launcher: `python -m repro_torch.launch.serve --mode sparql|lm`.

sparql — stand up the MapSQ engine + micro-batching server over LUBM data
         and run the 5 benchmark queries through it, `--n-queries` copies
         of each from concurrent client threads. The engine runs on the
         card; `--device cpu` runs it on the CPU instead. `--shards N`
         opens the store subject-hash sharded over N shards, all held on
         the one device (ShardedQueryEngine). Started as N ranks by a
         launcher, one shard per rank:

           python -m torch.distributed.run --standalone --nproc-per-node N \\
               -m repro_torch.launch.serve --mode sparql --shards N \\
               [--device cpu]

         rank 0 serves and the others follow it (NCCL between cards, gloo
         on the CPU; `--backend gloo` lets the ranks share one card).
lm     — reduced-config LM generation (prefill + greedy decode loop) of
         `--arch` (default gemma3-1b), seeded random weights, on the card
         or, with `--device cpu`, on the CPU. Started as N ranks by a
         launcher, the MoE archs run expert-parallel over the N ranks
         (ep = N, as the reference serves with model = device count):

           python -m torch.distributed.run --standalone --nproc-per-node N \\
               -m repro_torch.launch.serve --mode lm --arch olmoe-1b-7b \\
               [--device cpu]

         every rank generates, rank 0 prints.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import threading


def rows_digest(rows) -> str:
    """A result's row multiset as a short sha1 (row order aside), to hold
    one server's answers against another's."""
    key = sorted(sorted(r.items()) for r in rows)
    return hashlib.sha1(repr(key).encode()).hexdigest()[:12]


def serve_sparql(scale: int, n_queries: int, device: str | None = None,
                 shards: int = 0, backend: str | None = None) -> None:
    """`shards > 0` opens the store SHARDED: subject-hash partitioned over
    `shards` shards, queries served by the distributed executor (one
    sharded dispatch per warm query). Under a launcher (WORLD_SIZE set)
    each of the `shards` ranks holds one shard."""
    from repro_torch.serve.sparql_server import SPARQLServer
    from repro_torch.sparql.engine import QueryEngine, ShardedQueryEngine
    from repro_torch.sparql.lubm import QUERIES, generate

    ranks = None
    if "WORLD_SIZE" in os.environ:
        from repro_torch.core.ranks import init_ranks

        world = int(os.environ["WORLD_SIZE"])
        if shards != world:
            raise SystemExit(
                f"--shards {shards} under a launcher of {world} ranks: one "
                "shard per rank"
            )
        ranks = init_ranks(device=device, backend=backend)
    try:
        store = generate(scale=scale)
        lead = ranks is None or ranks.rank == 0
        if lead:
            print(f"LUBM-ish store: {len(store)} triples")
        if shards > 0:
            from repro_torch.sparql.sharded_store import shard_store

            sharded = shard_store(store, shards)
            engine: QueryEngine = ShardedQueryEngine(
                sharded, device=device, ranks=ranks
            )
            if lead:
                where = ("one per rank, backend " + ranks.backend
                         if ranks is not None else "on one device")
                print(f"sharded over {shards} shard(s), {where}: "
                      f"per-shard triples {sharded.shard_sizes()}")
            else:
                engine.follow()
                return
        else:
            engine = QueryEngine(store, device=device)
        srv = SPARQLServer(engine)
        results = {}

        def ask(name, text):
            results[name] = srv.query(text)

        threads = [
            threading.Thread(target=ask, args=(f"{name}#{i}", text))
            for i in range(n_queries)
            for name, text in QUERIES.items()
        ]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            for name in sorted(results):
                rows = results[name].rows
                print(f"{name}: {len(rows)} rows, sha1 {rows_digest(rows)}")
            print("server stats:", srv.stats())
        finally:
            srv.close()
            if ranks is not None:
                engine.close()
    finally:
        if ranks is not None:
            ranks.close()


def serve_lm(arch: str, device: str | None = None,
             backend: str | None = None) -> None:
    """Generate 16 tokens for two 4-token prompts. Under a launcher
    (WORLD_SIZE set) the experts shard over every rank (mesh (1, world)
    over ("data", "model")); rank 0 prints."""
    import importlib

    import numpy as np
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch.train import reduced_lm
    from repro_torch.models import transformer as T
    from repro_torch.serve.decode import Generator

    ranks = None
    if "WORLD_SIZE" in os.environ:
        from repro_torch.core.ranks import init_ranks

        ranks = init_ranks(device=device, backend=backend,
                           axis_sizes=(1, int(os.environ["WORLD_SIZE"])),
                           axis_names=("data", "model"))
    try:
        dev = ranks.device if ranks is not None else resolve_device(device)
        cfg = reduced_lm(importlib.import_module(ARCHS[arch]).CONFIG)
        # drawn on the CPU, so the card and the CPU serve the same weights
        params = T.init_params(torch.Generator().manual_seed(0), cfg,
                               ranks=ranks)
        gen = Generator(cfg, params, device=dev, max_len=64, ranks=ranks)
        prompts = np.arange(8, dtype=np.int32).reshape(2, 4) % cfg.vocab
        out = gen.generate(prompts, n_new=16)
        if ranks is None or ranks.rank == 0:
            if ranks is not None:
                print(f"expert-parallel over {ranks.world_size} ranks, "
                      f"backend {ranks.backend}")
            print("generated:", out.shape)
            print(out)
    finally:
        if ranks is not None:
            ranks.close()


def main() -> None:
    from repro_torch.configs.registry import archs_of

    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["sparql", "lm"], default="sparql")
    ap.add_argument("--arch", choices=archs_of("lm"), default="gemma3-1b",
                    help="--mode lm: the LM arch (its reduced config)")
    ap.add_argument("--scale", type=int, default=2)
    ap.add_argument("--n-queries", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the card; under "
                         "a launcher cuda:LOCAL_RANK)")
    ap.add_argument("--shards", type=int, default=0,
                    help="open the store sharded over this many shards "
                         "(0 = single-device store); under a launcher, "
                         "the number of ranks")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="under a launcher: the ranks' backend (default: "
                         "NCCL on cards, gloo on the CPU)")
    args = ap.parse_args()
    if args.mode == "lm":
        serve_lm(args.arch, args.device, args.backend)
    else:
        serve_sparql(args.scale, args.n_queries, args.device, args.shards,
                     args.backend)


if __name__ == "__main__":
    main()
