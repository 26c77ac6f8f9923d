"""Drive the PyTorch port of MapSQ on one NVIDIA GPU and hold it to its
references.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no "ok" line):

  1. card and build — the card's name and power limit; every CUDA kernel
     source built with nvcc for sm_90a, one process per source, together.
  2. kernels — each kernel against its plain PyTorch version on the card,
     bit for bit, at the shapes the main path gives it; kernel, plain and
     one-library-call times from CUDA events, beside the least time the
     card could take for the function (bytes moved over 3.35 TB/s, or the
     int32 operations a sort-based or merge-based algorithm needs over
     16.75 T/s, whichever is larger); the compares the kernel's own
     algorithm does are logged beside it.
  3. small scale — LUBM scale 2 with the join and skew subgraphs: every
     query shape under every join backend, on the card and on the CPU,
     result arrays equal in order.
  4. full scale — LUBM scale 1000 (~5.5M triples) through
     QueryEngine.prepare(text).run() on the card, cold then warm: rows
     equal the port on the CPU and, as sets, the hash-join oracle; a warm
     repeat is 1 dispatch and 0 compiles with no host sync inside the plan
     program; every kernel was launched; warm latency percentiles and
     peak device memory.
  5. summary — the kernels line, the card line, then the result line.

Needs the repository's src/ beside it and one CUDA card; exits non-zero
without them.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet), at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
# int32 issue rate: the data sheet's 67 TFLOP/s float32 rate counts an FMA
# as two operations on 128 lanes per SM; a Hopper SM has 64 int32 lanes,
# one compare or add each per clock, so a quarter of that
INT32_OPS_PER_S = 67e12 / 4
FULL_SCALE = 1000
SMALL_SCALE = 2
WARM_REPEATS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# -- timing --------------------------------------------------------------------


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events over `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: int, n_ops: int) -> tuple[float, str]:
    """Least time for the function: `n_bytes` each input read once and
    each output written once, `n_ops` the int32 operations the least
    algorithm needs (not the kernel's own)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def n_log_n(n: int) -> int:
    """Compares of a comparison sort of n keys."""
    return n * max(1, (n - 1).bit_length())


def max_abs_err(got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"shape/dtype {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
        diff = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(diff.max()) if diff.numel() else 0)
    return err


# -- phase 2: kernels ----------------------------------------------------------


def kernel_phase(dev) -> dict[str, dict]:
    from repro_torch import kernels
    from repro_torch.kernels.pair_expand import kernel as pek, ref as per
    from repro_torch.kernels.spmm_join import kernel as smk, ref as smr

    gen = torch.Generator().manual_seed(0)
    out: dict[str, dict] = {}
    int_max = 2**31 - 1

    def record(name, shape, err, k_ms, p_ms, b, algo_ops, lib_ms, source,
               replaces):
        b_ms, b_by = b
        log(f"kernel {name} {shape}: max_abs_err={err} kernel_ms={k_ms:.6f} "
            f"plain_ms={p_ms:.6f} bound_ms={b_ms:.9f} ({b_by}) "
            f"kernel_algorithm_ops={algo_ops} "
            f"library_ms={'null' if lib_ms is None else f'{lib_ms:.6f}'}")
        check(err == 0, f"{name} {shape} differs from its plain version")
        out[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms,
        }

    # pair_expand at the engine's largest buckets
    n_left, cap = 1 << 20, 1 << 22
    counts = torch.randint(0, 7, (n_left,), generator=gen, dtype=torch.int32)
    prefix = torch.cumsum(counts, 0, dtype=torch.int32).to(dev)
    counts = counts.to(dev)
    got = pek.pair_expand_cuda(prefix, counts, cap)
    want = per.pair_expand(prefix, counts, cap)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    slots = torch.arange(cap, dtype=torch.int32, device=dev)
    record(
        "pair_expand", f"n_left={n_left} capacity={cap}", err,
        time_ms(lambda: pek.pair_expand_cuda(prefix, counts, cap)),
        time_ms(lambda: per.pair_expand(prefix, counts, cap)),
        # prefix and counts read once; i, off (int32) and valid (bool) out;
        # a merge of the slots with prefix is one compare per element
        bound(8 * n_left + 9 * cap, n_left + cap),
        cap * (n_left.bit_length() + 1),  # a binary search per slot
        time_ms(lambda: torch.searchsorted(prefix, slots, right=True)),
        "src/repro_torch/kernels/pair_expand/csrc/pair_expand.cu",
        "src/repro/kernels/pair_expand/kernel.py:25",
    )

    # match_layout at the S1 shape and at the optimizer's dense cap
    for n_l, n_r in ((1024, 64), (4096, 1024)):
        lk = torch.randint(0, 97, (n_l,), generator=gen, dtype=torch.int32)
        rk = torch.randint(0, 97, (n_r,), generator=gen, dtype=torch.int32)
        lk[-(n_l // 8):] = int_max  # invalid-left sentinels
        rk[-(n_r // 8):] = int_max - 1  # invalid-right sentinels
        lk, rk = lk.to(dev), rk.to(dev)
        got = smk.match_layout_cuda(lk, rk)
        want = smr.match_layout(lk, rk)
        torch.cuda.synchronize()
        record(
            "match_layout", f"n_l={n_l} n_r={n_r}", max_abs_err(got, want),
            time_ms(lambda: smk.match_layout_cuda(lk, rk)),
            time_ms(lambda: smr.match_layout(lk, rk)),
            # keys read once, four int32 outputs written once; a sort of
            # both sides and a merge give every output
            bound(4 * (n_l + n_r) + 4 * (3 * n_l + n_r), n_log_n(n_l + n_r)),
            # eq and lt per (i, j); earlier-equal left keys per row pair
            # (at most: blocks with no match skip that pass)
            2 * n_l * n_r + n_l * (n_l - 1) // 2,
            None,
            "src/repro_torch/kernels/spmm_join/csrc/match_layout.cu",
            "src/repro/kernels/spmm_join/kernel.py:29",
        )

    # sort_ranks over the right side of a matrix join
    for n in (1024, 4096):
        keys = torch.randint(0, max(2, n // 3), (n,), generator=gen,
                             dtype=torch.int32).to(dev)
        got = smk.sort_ranks_cuda(keys)
        want = smr.sort_ranks(keys)
        perm = torch.argsort(keys, stable=True)
        torch.cuda.synchronize()
        check(torch.equal(got[perm].cpu(), torch.arange(n, dtype=torch.int32)),
              "sort_ranks is not the inverse of the stable argsort")
        record(
            "sort_ranks", f"n={n}", max_abs_err([got], [want]),
            time_ms(lambda: smk.sort_ranks_cuda(keys)),
            time_ms(lambda: smr.sort_ranks(keys)),
            bound(8 * n, n_log_n(n)),  # a stable comparison sort
            2 * n * n,  # lt and eq per key pair
            time_ms(lambda: torch.argsort(keys, stable=True)),
            "src/repro_torch/kernels/spmm_join/csrc/sort_ranks.cu",
            "src/repro/kernels/spmm_join/kernel.py:57",
        )
    kernels.LAUNCHES.clear()  # comparison launches do not count
    return out


# -- phases 3 and 4: the engine ------------------------------------------------


def all_queries(lubm) -> dict[str, str]:
    qs = dict(lubm.QUERIES)
    qs.update(lubm.OPERATOR_QUERIES)
    qs.update(lubm.J_QUERIES)
    qs.update(lubm.S_QUERIES)
    return qs


def small_scale_phase(dev) -> None:
    from repro_torch.sparql import lubm
    from repro_torch.sparql.engine import QueryEngine
    from repro_torch.sparql.parser import parse
    from repro_torch.sparql.store import TripleStore

    base = lubm.generate(scale=SMALL_SCALE, join_shapes=True, skew_shapes=True)
    terms = [base.dictionary.decode(i) for i in range(len(base.dictionary))]
    log(f"small scale: {len(base)} triples")
    for backend in (None, "mr", "matrix"):
        # one store per engine, so neither sees the other's scan caches
        engines = {
            d: QueryEngine(
                TripleStore.from_arrays(base.triples, terms),
                device=d, join_backend=backend,
            )
            for d in (dev, "cpu")
        }
        for name, text in all_queries(lubm).items():
            q = parse(text)
            for run in ("cold", "warm"):
                res = {d: e.execute(q) for d, e in engines.items()}
                (rc, sc), (rh, sh) = res[dev], res["cpu"]
                check(rc.schema == rh.schema, f"{name} schema")
                check(torch.equal(rc.cols.cpu(), rh.cols)
                      and torch.equal(rc.valid.cpu(), rh.valid),
                      f"{name} [{backend}] {run}: cuda arrays != cpu arrays")
                check(sc.join_totals == sh.join_totals
                      and sc.join_caps == sh.join_caps,
                      f"{name} [{backend}] {run}: join totals/caps differ")
                if run == "warm":
                    check(sc.n_dispatches == 1 and sc.n_compiles == 0,
                          f"{name} [{backend}] warm run: {sc}")
        log(f"small scale [{backend or 'optimizer'}]: "
            f"{len(all_queries(lubm))} queries, cuda == cpu")


def oracle_rows(store, text: str) -> set[tuple]:
    """Hash-join the patterns in greedy order on the host, as
    examples/sparql_lubm.py validates the reference engine."""
    from repro_torch.core.planner import plan_bgp
    from repro_torch.sparql.baseline import hash_join
    from repro_torch.sparql.parser import parse

    q = parse(text)
    steps = plan_bgp(q.patterns, store.estimate_cardinality)
    parts = [store.match_pattern(q.patterns[s.pattern_index], "cpu")
             for s in steps]
    sch, rows = parts[0].schema, parts[0].to_numpy()
    for p in parts[1:]:
        sch, rows = hash_join(sch, rows, p.schema, p.to_numpy())
    idx = [sch.index(v) for v in q.projection()]
    return {tuple(int(r[i]) for i in idx) for r in rows}


def warm_without_sync(engine, pq) -> None:
    """Call the cached plan program with sync debugging set to "error": a
    host sync or data-dependent shape inside the program raises. The only
    sync is the flag read after it."""
    canon_scans, shape, _ = engine._canonicalize(pq._program)
    consts = engine._device_consts(pq._program)
    entry = engine.plan_cache.get(shape)
    check(entry is not None, "warm shape is not in the plan cache")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        result = entry.compiled(canon_scans, *consts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(not bool(result.overflows.any()), "warm program overflowed")


def full_scale_phase(dev) -> dict:
    from repro_torch import kernels
    from repro_torch.sparql import lubm
    from repro_torch.sparql.engine import QueryEngine
    from repro_torch.sparql.parser import parse

    t0 = time.perf_counter()
    store = lubm.generate(scale=FULL_SCALE, join_shapes=True, skew_shapes=True)
    log(f"full scale: LUBM scale {FULL_SCALE}, {len(store)} triples, "
        f"{len(store.dictionary)} terms, generated in "
        f"{time.perf_counter() - t0:.1f} s (host)")
    names = list(lubm.QUERIES) + list(lubm.S_QUERIES)
    texts = {**lubm.QUERIES, **lubm.S_QUERIES}
    cpu_engine = QueryEngine(store, device="cpu")
    cpu_rows = {}
    for name in names:
        t = time.perf_counter()
        cpu_rows[name] = cpu_engine.query(texts[name])
        log(f"  cpu {name}: {len(cpu_rows[name])} rows "
            f"({time.perf_counter() - t:.2f} s)")

    engine = QueryEngine(store, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.LAUNCHES.clear()  # the main path's launches start here
    report = {}
    for name in names:
        pq = engine.prepare(texts[name])
        t = time.perf_counter()
        cold = pq.run()
        cold_s = time.perf_counter() - t
        check(cold.rows == cpu_rows[name], f"{name} cold: cuda rows != cpu rows")
        lat, dev_lat = [], []
        before = dict(kernels.LAUNCHES)
        for _ in range(WARM_REPEATS):
            t = time.perf_counter()
            warm = pq.run()
            lat.append(time.perf_counter() - t)
            dev_lat.append(warm.stats.device_time_s)
            check(warm.stats.n_dispatches == 1 and warm.stats.n_compiles == 0,
                  f"{name} warm: {warm.stats}")
        check(warm.rows == cpu_rows[name], f"{name} warm: cuda rows != cpu rows")
        per_run = {
            k: (v - before.get(k, 0)) / WARM_REPEATS
            for k, v in kernels.LAUNCHES.items()
        }
        warm_without_sync(engine, pq)
        backends = pq._program.plan.join_backends
        if name == "S1":
            check("matrix" in backends, f"S1 did not route to matrix: {backends}")
        lat.sort()
        dev_lat.sort()
        p99 = lambda xs: xs[min(len(xs) - 1, int(0.99 * len(xs)))]  # noqa: E731
        report[name] = {
            "rows": len(warm.rows), "backends": list(backends),
            "cold_s": cold_s, "warm_p50_ms": statistics.median(lat) * 1e3,
            "warm_p99_ms": p99(lat) * 1e3,
            "device_p50_ms": statistics.median(dev_lat) * 1e3,
            "device_p99_ms": p99(dev_lat) * 1e3,
            "join_totals": list(warm.stats.join_totals),
            "warm_launches_per_run": per_run,
        }
        log(f"  cuda {name}: {report[name]}")
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"full scale: peak device memory {peak} bytes; launches {launches}")
    for k in ("pair_expand", "match_layout", "sort_ranks"):
        check(launches.get(k, 0) > 0, f"kernel {k} was not launched")

    t = time.perf_counter()
    d = store.dictionary
    for name in names:
        proj = parse(texts[name]).projection()
        got = {tuple(d.lookup(r[v]) for v in proj) for r in cpu_rows[name]}
        check(got == oracle_rows(store, texts[name]),
              f"{name}: rows != hash-join oracle")
    log(f"full scale: all {len(names)} queries equal the hash-join oracle "
        f"({time.perf_counter() - t:.1f} s, host)")
    return {"launches": launches, "peak_bytes": peak, "queries": report}


# -- main ----------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        fail(f"the port's package is missing under {src}")
    sys.path.insert(0, str(src))
    from repro_torch import kernels

    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t = time.perf_counter()
    kernels.build_all()
    log(f"build: {len(kernels.all_sources())} kernel sources in "
        f"{time.perf_counter() - t:.2f} s")

    rows = kernel_phase(dev)
    small_scale_phase(dev)
    full = full_scale_phase(dev)
    for name, row in rows.items():
        row["launches"] = full["launches"][name]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"full_scale": full}), flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
