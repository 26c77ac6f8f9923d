"""Serving launcher: `python -m repro_torch.launch.serve --mode sparql`.

sparql — stand up the MapSQ engine + micro-batching server over LUBM data
         and run the 5 benchmark queries through it, `--n-queries` copies
         of each from concurrent client threads. The engine runs on the
         card; `--device cpu` runs it on the CPU instead.
"""
from __future__ import annotations

import argparse
import threading


def serve_sparql(scale: int, n_queries: int, device: str | None = None) -> None:
    from repro_torch.serve.sparql_server import SPARQLServer
    from repro_torch.sparql.engine import QueryEngine
    from repro_torch.sparql.lubm import QUERIES, generate

    store = generate(scale=scale)
    print(f"LUBM-ish store: {len(store)} triples")
    srv = SPARQLServer(QueryEngine(store, device=device))
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
    args = ap.parse_args()
    serve_sparql(args.scale, args.n_queries, args.device)


if __name__ == "__main__":
    main()
