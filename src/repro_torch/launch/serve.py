"""Serving launcher: `python -m repro_torch.launch.serve --mode sparql`.

sparql — stand up the MapSQ engine + micro-batching server over LUBM data
         and run the 5 benchmark queries through it, `--n-queries` copies
         of each from concurrent client threads. The engine runs on the
         card; `--device cpu` runs it on the CPU instead. `--shards N`
         opens the store subject-hash sharded over N shards, all held on
         the one device (ShardedQueryEngine).
"""
from __future__ import annotations

import argparse
import threading


def serve_sparql(scale: int, n_queries: int, device: str | None = None,
                 shards: int = 0) -> None:
    """`shards > 0` opens the store SHARDED: subject-hash partitioned over
    `shards` shards, queries served by the distributed executor (one
    sharded dispatch per warm query)."""
    from repro_torch.serve.sparql_server import SPARQLServer
    from repro_torch.sparql.engine import QueryEngine, ShardedQueryEngine
    from repro_torch.sparql.lubm import QUERIES, generate

    store = generate(scale=scale)
    print(f"LUBM-ish store: {len(store)} triples")
    if shards > 0:
        from repro_torch.sparql.sharded_store import shard_store

        sharded = shard_store(store, shards)
        print(f"sharded over {shards} shard(s): "
              f"per-shard triples {sharded.shard_sizes()}")
        engine: QueryEngine = ShardedQueryEngine(sharded, device=device)
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
            print(f"{name}: {len(results[name])} rows")
        print("server stats:", srv.stats())
    finally:
        srv.close()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["sparql"], default="sparql")
    ap.add_argument("--scale", type=int, default=2)
    ap.add_argument("--n-queries", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the card)")
    ap.add_argument("--shards", type=int, default=0,
                    help="open the store sharded over this many shards "
                         "(0 = single-device store)")
    args = ap.parse_args()
    serve_sparql(args.scale, args.n_queries, args.device, args.shards)


if __name__ == "__main__":
    main()
