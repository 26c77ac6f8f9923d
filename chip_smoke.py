"""Drive the PyTorch port of MapSQ on one NVIDIA GPU and hold it to its
references.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no "ok" line):

  1. card and build — the card's name and power limit; every CUDA kernel
     source built with nvcc for sm_90a, one process per source, together.
  2. kernels — each kernel against its plain PyTorch version on the card,
     at the shapes the main path gives it (int32 kernels bit for bit, the
     pair sort on its keys and its (key, payload) multiset, the segment
     sum within the reference test's tolerances); kernel, plain and
     one-library-call times from CUDA events, beside the least time the
     card could take for the function (bytes moved over 3.35 TB/s, or the
     int32 operations a sort-based or merge-based algorithm needs over
     16.75 T/s, whichever is larger); the compares the kernel's own
     algorithm does are logged beside it. The stacked (lane-axis) form of
     pair_expand, match_layout and sort_ranks at 8 lanes against 8 single
     calls, both timed, at a small shape and at the engine's largest
     buckets, with invalid-row sentinel keys.
  3. kernel API — the public sort_pairs, argsort_i32 and
     sorted_segment_sum at the reference benchmark's shapes (the path that
     runs bitonic_sort and segment_reduce), held to their plain versions.
  4. small scale — LUBM scale 2 with the join and skew subgraphs: every
     query shape under every join backend, on the card and on the CPU,
     result arrays equal in order; then run_batch over same-shape
     FILTER-constant variants and near-miss (padded) shapes, every lane's
     arrays equal between card and CPU, and one stacked program run with
     sync debugging set to "error".
  5. full scale — LUBM scale 1000 (~5.5M triples) through
     QueryEngine.prepare(text).run() on the card, cold then warm: rows
     equal the port on the CPU and, as sets, the hash-join oracle; a warm
     repeat is 1 dispatch and 0 compiles with no host sync inside the plan
     program; every kernel was launched; warm latency percentiles and
     peak device memory.
  6. serving — SPARQLServer on the full-scale store, on the card: two
     rounds of bursts of concurrent same-shape requests (the first pays
     each width's first use; the summary reads the second, which starts
     with another query); every result
     equals the single-query rows on the card and the CPU's; stacked
     dispatches of width >= 8 that launch each kernel as often as one
     warm single-query run (whose device part is logged beside a width-8
     dispatch's); no group fell back, no request timed out or failed;
     request latency percentiles, each burst's dispatch seconds, device
     part and new allocator segments, queries per dispatch and peak
     device memory.
  7. summary — the stacked-forms line, the kernels line, the card line,
     then the result line.

Each of the paths of phases 3, 5 and 6 runs with the launch counts set to
0 just before it and read just after; the kernels line reports each
kernel's launches from the path that runs it.

Needs the repository's src/ beside it and one CUDA card; exits non-zero
without them.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import threading
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


def float_err(got, want, rtol: float, atol: float) -> float:
    """Max abs error of a float result; fails beyond rtol/atol."""
    check(got.shape == want.shape, f"shape {tuple(got.shape)} vs {tuple(want.shape)}")
    diff = (got.float() - want.float()).abs()
    check(bool((diff <= atol + rtol * want.float().abs()).all()),
          f"float result beyond rtol={rtol} atol={atol}")
    return float(diff.max()) if diff.numel() else 0.0


def pair_multiset(keys, vals):
    """(key, payload) pairs as sorted int64 codes: equal iff the pair
    multisets are equal."""
    return torch.sort(keys.long() * 2**32 + (vals.long() & 0xFFFFFFFF)).values


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
    from repro_torch.kernels.bitonic_sort import kernel as bsk, ref as bsr
    from repro_torch.kernels.pair_expand import kernel as pek, ref as per
    from repro_torch.kernels.segment_reduce import kernel as srk, ref as srr
    from repro_torch.kernels.spmm_join import kernel as smk, ref as smr

    gen = torch.Generator().manual_seed(0)
    out: dict[str, dict] = {}
    int_max = 2**31 - 1

    def record(name, shape, err, k_ms, p_ms, b, algo_ops, lib_ms, source,
               replaces, exact=True):
        b_ms, b_by = b
        log(f"kernel {name} {shape}: max_abs_err={err} kernel_ms={k_ms:.6f} "
            f"plain_ms={p_ms:.6f} bound_ms={b_ms:.9f} ({b_by}) "
            f"kernel_algorithm_ops={algo_ops} "
            f"library_ms={'null' if lib_ms is None else f'{lib_ms:.6f}'}")
        if exact:
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

    # bitonic_sort: the reference benchmark's n, the reference kernel's
    # largest block, and the engine's largest bucket plus 3 (above one
    # block's shared memory, not a power of two)
    for n in (4096, 1 << 19, (1 << 22) + 3):
        keys = torch.randint(-(2**31), int_max, (n,), generator=gen,
                             dtype=torch.int32)
        keys[: n // 2] %= 1 << 16  # duplicate keys
        keys[torch.rand(n, generator=gen) < 0.001] = int_max
        vals = torch.randint(-(2**31), int_max, (n,), generator=gen,
                             dtype=torch.int32)
        keys, vals = keys.to(dev), vals.to(dev)
        gk, gv = bsk.sort_pairs_cuda(keys, vals)
        wk, wv = bsr.sort_pairs(keys, vals)
        torch.cuda.synchronize()
        check(torch.equal(pair_multiset(gk, gv), pair_multiset(wk, wv)),
              f"bitonic_sort n={n}: (key, payload) multisets differ")
        record(
            "bitonic_sort", f"n={n}", max_abs_err([gk], [wk]),
            time_ms(lambda: bsk.sort_pairs_cuda(keys, vals)),
            time_ms(lambda: bsr.sort_pairs(keys, vals)),
            # keys and payloads read once and written once; a comparison
            # sort's n log2 n compares
            bound(16 * n, n_log_n(n)),
            # the network's compares over its power-of-two span m
            (1 << (n - 1).bit_length()) // 2
            * ((n - 1).bit_length() * ((n - 1).bit_length() + 1) // 2),
            time_ms(lambda: torch.sort(keys)),
            "src/repro_torch/kernels/bitonic_sort/csrc/bitonic_sort.cu",
            "src/repro/kernels/bitonic_sort/kernel.py:42",
        )

    # segment_reduce: the reference benchmark's shape, the reference
    # kernel's largest segment count in float32 and bfloat16, and 16x that
    for n, d, segs, dtype in ((2048, 64, 128, torch.float32),
                              (1 << 20, 128, 4096, torch.float32),
                              (1 << 20, 128, 4096, torch.bfloat16),
                              (1 << 20, 128, 65536, torch.float32)):
        ids = torch.sort(torch.randint(0, segs, (n,), generator=gen,
                                       dtype=torch.int32)).values.to(dev)
        data32 = torch.randn(n, d, generator=gen).to(dev)
        data = data32.to(dtype)
        got = srk.sorted_segment_sum_cuda(data, ids, segs)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            err = float_err(got, srr.sorted_segment_sum(data, ids, segs),
                            1e-5, 1e-4)
        else:  # bf16 against the float32 result, the reference's bounds
            err = float_err(got, srr.sorted_segment_sum(data32, ids, segs),
                            5e-2, 0.3)
        size = data.element_size()
        record(
            "segment_reduce", f"n={n} d={d} segments={segs} {dtype}", err,
            time_ms(lambda: srk.sorted_segment_sum_cuda(data, ids, segs)),
            time_ms(lambda: srr.sorted_segment_sum(data, ids, segs)),
            # data and ids read once, out written once; n*d adds
            bound(n * d * size + 4 * n + segs * d * size, n * d),
            n * d,
            time_ms(lambda: torch.zeros(segs, d, dtype=dtype, device=dev)
                    .index_add_(0, ids, data)),
            "src/repro_torch/kernels/segment_reduce/csrc/segment_sum.cu",
            "src/repro/kernels/segment_reduce/kernel.py:25",
            exact=False,
        )
    kernels.LAUNCHES.clear()  # comparison launches do not count
    return out


def stacked_phase(dev) -> list[dict]:
    """The lane-axis form of each slice-1 kernel at 8 lanes (one launch)
    against 8 single calls, bit for bit, both timed: at a small shape and
    at the engine's largest buckets, with the invalid-row sentinels
    (INT32_MAX left keys, INT32_MAX - 1 right keys) the matrix join gives
    its kernels."""
    from repro_torch import kernels
    from repro_torch.kernels.pair_expand import kernel as pek
    from repro_torch.kernels.spmm_join import kernel as smk

    gen = torch.Generator().manual_seed(1)
    lanes = 8
    int_max = 2**31 - 1

    def keys(n, sentinel):
        k = torch.randint(0, max(2, n // 3), (lanes, n), generator=gen,
                          dtype=torch.int32)
        k[:, -(n // 8):] = sentinel  # invalid rows, at the tail of each lane
        return k.to(dev)

    cases = []
    for n_left, cap, shape in ((1 << 16, 1 << 18, "n_left=2^16 capacity=2^18"),
                               (1 << 20, 1 << 22, "n_left=2^20 capacity=2^22")):
        counts = torch.randint(0, 7, (lanes, n_left), generator=gen,
                               dtype=torch.int32)
        prefix = torch.cumsum(counts, 1, dtype=torch.int32).to(dev)
        cases.append(("pair_expand",
                      lambda x, cap=cap: pek.pair_expand_cuda(*x, cap),
                      (prefix, counts.to(dev)), shape))
    for n_l, n_r in ((1024, 64), (4096, 1024)):
        lk, rk = keys(n_l, int_max), keys(n_r, int_max - 1)
        cases.append(("match_layout", lambda x: smk.match_layout_cuda(*x),
                      (lk, rk), f"n_l={n_l} n_r={n_r} sentinels"))
        cases.append(("sort_ranks", lambda x: (smk.sort_ranks_cuda(*x),),
                      (rk,), f"n={n_r} sentinels"))
    rows = []
    for name, fn, args, shape in cases:
        stacked = fn(args)
        singles = [fn([a[w] for a in args]) for w in range(lanes)]
        torch.cuda.synchronize()
        err = max(max_abs_err([s[w] for s in stacked], singles[w])
                  for w in range(lanes))
        check(err == 0, f"stacked {name} {shape} differs from its single calls")
        row = {
            "name": name, "lanes": lanes, "shape": shape,
            "max_abs_err": err,
            "stacked_ms": time_ms(lambda: fn(args)),
            "singles_ms": time_ms(
                lambda: [fn([a[w] for a in args]) for w in range(lanes)]),
        }
        log(f"stacked {row}")
        rows.append(row)
        del stacked, singles
    kernels.LAUNCHES.clear()  # comparison launches do not count
    return rows


def kernel_api_phase(dev) -> dict:
    """The path that runs bitonic_sort and segment_reduce: their public
    ops at the reference benchmark's shapes (benchmarks/run.py
    bench_kernels), held to the plain versions."""
    from repro_torch import kernels
    from repro_torch.kernels.bitonic_sort import ops as bso, ref as bsr
    from repro_torch.kernels.segment_reduce import ops as sro, ref as srr

    gen = torch.Generator().manual_seed(2)
    keys = torch.randint(0, 1 << 20, (4096,), generator=gen,
                         dtype=torch.int32).to(dev)
    vals = torch.arange(4096, dtype=torch.int32, device=dev)
    data = torch.randn(2048, 64, generator=gen).to(dev)
    ids = torch.sort(torch.randint(-2, 130, (2048,), generator=gen,
                                   dtype=torch.int32)).values.to(dev)
    torch.cuda.synchronize()
    kernels.LAUNCHES.clear()  # the kernel-API path's launches start here
    sk, sv = bso.sort_pairs(keys, vals)
    order = bso.argsort_i32(keys)
    seg = sro.sorted_segment_sum(data, ids, 128)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    wk, wv = bsr.sort_pairs(keys, vals)
    check(torch.equal(sk, wk)
          and torch.equal(pair_multiset(sk, sv), pair_multiset(wk, wv)),
          "sort_pairs differs from its plain version")
    check(torch.equal(keys[order.long()], wk)
          and torch.equal(torch.sort(order).values, vals),
          "argsort_i32 is not a sorting permutation")
    float_err(seg, srr.sorted_segment_sum(data, ids, 128), 1e-5, 1e-4)
    log(f"kernel API: sort_pairs, argsort_i32, sorted_segment_sum equal "
        f"their plain versions; launches {launches}")
    for k in ("bitonic_sort", "segment_reduce"):
        check(launches.get(k, 0) > 0, f"kernel {k} was not launched")
    return launches


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
    small_batch_phase(dev, base, terms)


def batch_texts(lubm) -> list[str]:
    """Same-shape FILTER-constant variants of Q1, Q4, Q7 and F1, and two
    families of near-miss shapes (one plan, other pow-2 scan buckets) that
    padded stacking merges."""
    qs = {**lubm.QUERIES, **lubm.OPERATOR_QUERIES}
    variants = {
        "Q1": ("Course0_0_0", ("Course0_0_0", "Course0_0_1", "Course0_1_0",
                               "Course1_0_0")),
        "Q4": ("Dept0_0", ("Dept0_0", "Dept0_1", "Dept1_0", "Dept1_1")),
        "Q7": ("Prof0_0_0", ("Prof0_0_0", "Prof0_0_1", "Prof1_0_0",
                             "Prof1_0_1")),
        "F1": ("prof_0_0_0", ("prof_0_0_0", "prof_0_1_0", "prof_1_0_0",
                              "nobody")),
    }
    texts = [qs[q].replace(old, new) for q, (old, news) in variants.items()
             for new in news for _ in range(2)]
    p = lubm.PREFIX
    near_miss = (
        "SELECT ?x ?y ?z WHERE { ?x ub:advisor ?y . ?y ub:worksFor ?z . }",
        "SELECT ?x ?y ?z WHERE { ?x ub:memberOf ?y . "
        "?y ub:subOrganizationOf ?z . }",
        "SELECT ?x ?y WHERE { ?x a ub:GraduateStudent . ?x ub:advisor ?y . }",
        "SELECT ?x ?y WHERE { ?x a ub:FullProfessor . ?x ub:worksFor ?y . }",
    )
    return texts + [p + t for t in near_miss for _ in range(4)]


def small_batch_phase(dev, base, terms) -> None:
    """run_batch on the card and on the CPU over the same batch: every
    lane's result arrays equal, array for array; then one stacked program
    with sync debugging set to "error"."""
    from repro_torch.sparql import lubm
    from repro_torch.sparql.engine import QueryEngine
    from repro_torch.sparql.store import TripleStore

    texts = batch_texts(lubm)
    for backend in (None, "matrix"):
        engines = {
            d: QueryEngine(TripleStore.from_arrays(base.triples, terms),
                           device=d, join_backend=backend)
            for d in (dev, "cpu")
        }
        lanes = {}
        for d, eng in engines.items():
            pqs = [eng.prepare(t) for t in texts]
            eng.run_batch(pqs)  # cold groups calibrate, the rest stack
            eng.run_batch(pqs)  # every shape warm: padded groups merge
            pending = eng.run_batch_pipelined(pqs)
            lanes[d] = [(pd.fetch.fetch()[:2], pd.lane, pd.resolve().rows)
                        for pd in pending]
            check(eng.padded_groups > 0, f"no padded group on {d}")
            check(not any(g.fallback for g in eng.last_batch),
                  f"a group fell back on {d}")
        for i, (((c1, v1), l1, r1), ((c2, v2), l2, r2)) in enumerate(
                zip(lanes[dev], lanes["cpu"])):
            check(l1 == l2, f"slot {i}: lane {l1} vs {l2}")
            a = (c1, v1) if l1 is None else (c1[l1], v1[l1])
            b = (c2, v2) if l2 is None else (c2[l2], v2[l2])
            check((a[0] == b[0]).all() and (a[1] == b[1]).all() and r1 == r2,
                  f"[{backend}] slot {i}: card arrays != cpu arrays")
        eng = engines[dev]
        log(f"small scale run_batch [{backend or 'optimizer'}]: "
            f"{len(texts)} queries, groups "
            f"{[(g.n_queries, g.widths, g.padded) for g in eng.last_batch]}, "
            f"cuda == cpu lane by lane")
    # Q4's department variants: one shape, the department scan stacked
    batch_without_sync(eng, [eng.prepare(t) for t in texts[8:16]])


def batch_without_sync(engine, pqs) -> None:
    """Call one cached stacked program with sync debugging set to "error":
    a host sync inside the program raises. Its inputs are staged first."""
    ctxs = [engine._batch_context(pq._program) for pq in pqs]
    shape = ctxs[0].shape
    check(len({c.shape for c in ctxs}) == 1, "lanes must share a shape")
    entry = engine.plan_cache.get(shape)
    inp = engine._stage_chunk(shape, ctxs, len(ctxs))
    bexec = entry.batched.get((len(ctxs), inp.scan_axes))
    check(bexec is not None, "the stacked program is not cached")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        result = bexec(inp.scans, inp.consts_i, inp.consts_f, inp.num_vals,
                       inp.active)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(not bool(result.overflows.any()), "stacked program overflowed")
    log(f"stacked program (width {len(ctxs)}, axes {inp.scan_axes}) ran "
        "with no host sync")


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
    card_rows = {}
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
        card_rows[name] = warm.rows
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
    return {"launches": launches, "peak_bytes": peak, "queries": report,
            "store": store, "texts": texts, "cpu_rows": cpu_rows,
            "card_rows": card_rows}


# -- phase 6: serving ----------------------------------------------------------


def burst_counters(srv) -> dict:
    """Where a burst's time goes: batcher-thread seconds in dispatch
    (staging + stacked program + flag read), the engine's device part
    (program + flag read), and cudaMalloc segments the allocator added."""
    return {
        "dispatch_s": srv.stats()["pipeline"]["dispatch_s"],
        "device_s": srv.engine.device_time_s,
        "segments": torch.cuda.memory_stats().get("segment.all.allocated", 0),
    }


def burst(srv, text: str, n: int, card_rows, cpu_rows) -> list[float]:
    """`n` concurrent requests of one text, released together; returns
    their sorted latencies (s) after checking every result."""
    gate = threading.Barrier(n)
    lat = [0.0] * n
    rows = [None] * n

    def ask(i):
        gate.wait()
        t0 = time.perf_counter()
        rows[i] = srv.query(text).rows
        lat[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(all(r == card_rows == cpu_rows for r in rows),
          "served rows != single-query rows")
    return sorted(lat)

BURSTS = {"Q1": 16, "Q2": 16, "Q4": 16, "Q7": 16, "S1": 16, "Q9": 4}
# round 2 starts with another query than round 1, so a burst slow for its
# place in the phase shows apart from one slow for its query
ROUND_ORDER = {1: list(BURSTS), 2: ["Q4", "Q1", "Q2", "Q7", "S1", "Q9"]}


def serving_phase(dev, full: dict) -> dict:
    """SPARQLServer on the full-scale store: concurrent bursts of
    same-shape requests, every result held to the single-query rows on the
    card and the CPU's."""
    from repro_torch import kernels
    from repro_torch.obs import parse_prometheus
    from repro_torch.serve.sparql_server import SPARQLServer
    from repro_torch.sparql.engine import QueryEngine

    texts, cpu_rows = full["texts"], full["cpu_rows"]
    engine = QueryEngine(full["store"], device=dev)
    srv = SPARQLServer(engine, max_batch=16, max_wait_s=0.02)
    groups = []  # every plan group of every micro-batch (batcher thread)
    dispatch = engine.run_batch_pipelined

    def recording(prepared, traces=None):
        out = dispatch(prepared, traces=traces)
        groups.extend(engine.last_batch)
        return out

    engine.run_batch_pipelined = recording
    report = {}
    try:
        for name in BURSTS:  # cold (calibration + compile), then warm
            srv.query(texts[name])
            srv.query(texts[name])
        # a stacked dispatch launches each kernel as often as one warm
        # single-query run
        for name in BURSTS:
            pq = engine.prepare(texts[name])
            pq.run()
            before = dict(kernels.LAUNCHES)
            warm = pq.run()
            single = {k: v - before.get(k, 0)
                      for k, v in kernels.LAUNCHES.items()}
            batch = [engine.prepare(texts[name]) for _ in range(8)]
            engine.run_batch(batch)  # builds the width-8 program
            before = dict(kernels.LAUNCHES)
            res = engine.run_batch(batch)
            stacked = {k: v - before.get(k, 0)
                       for k, v in kernels.LAUNCHES.items()}
            check(engine.last_batch[0].widths == (8,),
                  f"{name}: not one width-8 dispatch")
            check(stacked == single,
                  f"{name}: stacked launches {stacked} != single {single}")
            check(all(r.rows == cpu_rows[name] for r in res),
                  f"{name}: stacked rows != cpu rows")
            # device part (dispatch to flag read) of the width-8 dispatch
            # (its lanes' shares add up to it) beside one warm single run
            report[name] = {
                "launches_per_dispatch": stacked,
                "single_device_ms": warm.stats.device_time_s * 1e3,
                "stacked8_device_ms":
                    sum(r.stats.device_time_s for r in res) * 1e3,
            }
        batch_without_sync(engine, [engine.prepare(texts["S1"])] * 8)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.LAUNCHES.clear()  # the serving path's launches start here
        dispatched = engine.stacked_dispatches, engine.stacked_queries
        groups.clear()
        all_lat = []
        for rnd, order in ROUND_ORDER.items():
            for name in order:  # round 1 pays first use of each width
                n = BURSTS[name]
                before = burst_counters(srv)
                lat = burst(srv, texts[name], n, full["card_rows"][name],
                            cpu_rows[name])
                spent = {k: v - before[k]
                         for k, v in burst_counters(srv).items()}
                if rnd == 2:
                    all_lat += lat
                report[name].update({
                    f"round{rnd}_p50_ms": statistics.median(lat) * 1e3,
                    f"round{rnd}_p99_ms":
                        lat[min(n - 1, int(0.99 * n))] * 1e3,
                    f"round{rnd}_dispatch_ms": spent["dispatch_s"] * 1e3,
                    f"round{rnd}_device_ms": spent["device_s"] * 1e3,
                    f"round{rnd}_new_segments": spent["segments"],
                }, requests=n)
        for name in BURSTS:
            log(f"  serving {name}: {report[name]}")
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        st = srv.stats()
        outcomes = {
            labels["outcome"]: value for labels, value in parse_prometheus(
                srv.render_prometheus())["mapsq_requests_total"]
        }
    finally:
        srv.close()
    sd = engine.stacked_dispatches - dispatched[0]
    sq = engine.stacked_queries - dispatched[1]
    widths = [w for g in groups for w in g.widths]
    all_lat.sort()
    summary = {
        "requests": len(all_lat),  # round 2
        "p50_ms": statistics.median(all_lat) * 1e3,
        "p99_ms": all_lat[min(len(all_lat) - 1, int(0.99 * len(all_lat)))]
        * 1e3,
        "stacked_dispatches": sd, "stacked_queries": sq,
        "queries_per_dispatch": sq / sd if sd else 0.0,
        "widths": sorted(widths), "peak_bytes": peak, "launches": launches,
        "outcomes": outcomes,
    }
    log(f"serving: {summary}")
    check(max(widths, default=0) >= 8, f"no stacked dispatch of width >= 8: "
          f"{widths}")
    check(not any(g.fallback for g in groups), "a serving group fell back")
    check(st["timeouts"] == 0 and outcomes.get("timeout") == 0
          and outcomes.get("error") == 0, f"request outcomes {outcomes}")
    for k in ("pair_expand", "match_layout", "sort_ranks"):
        check(launches.get(k, 0) > 0, f"kernel {k} was not launched serving")
    return {"summary": summary, "queries": report}


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
    stacked = stacked_phase(dev)
    api_launches = kernel_api_phase(dev)
    small_scale_phase(dev)
    full = full_scale_phase(dev)
    serving = serving_phase(dev, full)
    for name, row in rows.items():
        row["launches"] = (full["launches"] | api_launches).get(name, 0)
        check(row["launches"] > 0, f"kernel {name} was not launched")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    full = {k: full[k] for k in ("launches", "peak_bytes", "queries")}
    print(json.dumps({"full_scale": full, "serving": serving}), flush=True)
    print(json.dumps({"stacked": stacked}), flush=True)
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
