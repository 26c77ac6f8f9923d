"""Drive the PyTorch port of MapSQ on one NVIDIA GPU and hold it to its
references.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no "ok" line):

  1. card and build — the card's name and power limit; every CUDA kernel
     source built with nvcc for sm_90a, one process per source, together.
  2. kernels — each kernel against its plain PyTorch version on the card,
     at the shapes the main path gives it (int32 kernels bit for bit, the
     pair sort on its keys and its (key, payload) multiset and, above one
     tile, on its payloads too; the segment sum within the reference
     test's tolerances of the exact sum, also with one segment holding
     half the rows and at phase 11's shapes (GraphCast's aggregations at
     minibatch_lg, DeepFM's one-row bags at serve_bulk), two calls
     bit-equal; each launcher call's device
     launches logged for those two and for sort_ranks, with a profiler
     breakdown by kernel; pair_expand also at the merge path's edges and
     at every (n_left, capacity) of the full-scale phase, single and
     stacked at the serving width, sort_ranks on both sides of its two
     paths' threshold and up to 2^20 + 3 keys, held there to the inverse
     of the stable argsort, match_layout on both sides of its two paths'
     threshold, at shapes the optimizer's cap admits and at Q9's largest
     join, held to the sorted oracle where the dense compares pass 2^26,
     with its path and compare count); kernel, plain and one-library-call
     device times from CUDA events around calls queued ahead of the card, the
     host's enqueue of one kernel call and one library call, and each
     call's cost (the larger of its device time and its enqueue), beside
     the least time the card could take for the function (bytes moved
     over 3.35 TB/s, or the int32 operations a sort-based or merge-based
     algorithm needs over 16.75 T/s, whichever is larger); the compares
     the kernel's own algorithm does are logged beside it. The stacked
     (lane-axis) form of pair_expand, match_layout and sort_ranks at 8
     lanes against 8 single calls, both timed, at a small shape and at
     the engine's largest buckets, with invalid-row sentinel keys, and
     sort_ranks and match_layout on their sorting paths.
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
     program; every kernel was launched; warm latency percentiles, peak
     device memory, and the shapes each query gives pair_expand and
     sort_ranks.
  6. matrix backend — the same queries with every join forced onto the
     matrix backend (join_backend="matrix", which has no size cap): rows
     equal in order to the mr backend's on the card and, as sets, the
     hash-join oracle; warm 1 dispatch, 0 compiles, no host sync, also
     in a stacked program of Q9; match_layout's shapes and paths.
  7. serving — SPARQLServer on the full-scale store, on the card: two
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
  8. sharded engine — LUBM scale 2 at 8 shards and on a 2 x 2 mesh (card
     arrays equal the CPU port's sharded engine's, rows the single-device
     engine's); then the full-scale store subject-hash sharded over 4
     shards, every shard on the one card (ShardedQueryEngine): every LUBM
     query and the F1 / O1 / FO1 / U1 / DISTINCT / LIMIT shapes (and S1,
     Q4 with every join on the matrix backend), rows equal as multisets
     to the single-device card engine's and, where it applies, the
     hash-join oracle's; warm 1 dispatch, 0 compiles, no host
     sync; Q9's worst per-shard join bucket below the single-device
     bucket; a program at the smallest join and shuffle buckets retried to
     the same rows; a stacked FILTER-constant group (also with no host
     sync) and a short server burst; warm p50 and device part of both
     engines, and for Q1, Q2, Q9 and S1 each engine's plan program alone
     (card busy time, device launches and the top kernels from the
     profiler, host enqueue); shuffles
     emitted / elided / broadcast per query, launches per kernel and peak
     device memory.
  9. sharded engine across processes — one shard per rank
     (ShardedQueryEngine(ranks=init_ranks(...))), ranks spawned with a
     file:// rendezvous under build/, the scale-1000 store written there
     once and loaded by each rank: 4 ranks sharing the card over gloo
     (exchanges staged through the host) run every phase 8 query, S1 on
     the matrix backend, a retry forced by a warmup file at the smallest
     buckets and a stacked FILTER-constant group; rank 0's result arrays
     and ExecStats equal fresh one-process engines' over phase 8's store
     (and its id rows the oracle's), every follower's runs report rank
     0's ExecStats, call for call (warm: 1 dispatch, 0 compiles on every
     rank), every rank launched pair_expand, match_layout and sort_ranks;
     each rank's launches, peak memory and rank 0's warm p50 of execute
     (no decode) beside the one-process engine's. Then a 2 x 2 mesh over
     4 ranks at scale 2 against the one-process 2 x 2 engine; NCCL at
     world = the card count (1 here: at scale 2, 4 cards: the scale-1000
     checks), every plan program called with sync debugging set to
     "error"; and `serve --shards 4` under torch.distributed.run (gloo on
     the card), every answer's row multiset the one-process engine's.
     Any rank's failure or hang fails the phase.
 10. LM serving — the port's transformer through Generator (prefill, then
     greedy decode over a static KV cache), no kernel of its own: (a) the
     reduced config of each of the five LM archs, float32 and bf16, the
     same seeded weights on the card and on the CPU port (float32: logits
     within rtol/atol 1e-4 and greedy tokens equal, decoded with sync
     debugging at "error"; bf16: logits within 5e-2); (b) gemma3-1b at
     full width and depth in bf16, 2 x 1024 prompt tokens and 64 new, the
     decode loop with sync debugging at "error", prefill ms, decode ms per
     token (p50 of 64 steps), tokens/s and peak memory beside their bounds,
     launches and card busy time (profiler) of a decode step and of a
     prefill, and the cached decode's logits at steps 1, 16 and 64 within
     0.25 of a cacheless forward over the grown sequence; (c) gemma3-1b at full width with 2 layers in float32, 2 x
     64 prompts and 8 new tokens, card against the CPU port (tokens equal,
     or a flip only at a top-two gap within the tolerance), TF32 off.
 11. GNN and recsys forward — the port's GNN family (`mod.apply`) and
     DeepFM (`sigmoid(forward)`, `retrieval_scores`), every sorted
     aggregation and embedding bag through segment_reduce: (a) the four
     GNN archs at the CPU tests' reduced configs (GraphCast also streamed
     in chunks, SchNet also on a molecule batch) and DeepFM's small
     config, card against the CPU port with the same seeded weights
     (outputs and losses within rtol/atol 1e-4); (b) gat-cora on
     full_graph_sm, schnet on molecule, GraphCast at its published width
     and depth on full_graph_sm's graph, card against the CPU port within
     1e-3, and DeepFM at its published config (33,540,000 rows) at
     serve_p99 and retrieval_cand against the CPU port within 1e-4; (c)
     at minibatch_lg's device dims, GraphCast in float32 and with a bf16
     compute_dtype (finite, bf16 within a stated bound of float32) and
     MeshGraphNet (against the CPU port), then DeepFM at serve_bulk held
     to the CPU port on its first 4,096 rows. Every forward's first call
     runs with sync debugging at "error" and launches segment_reduce
     exactly once per aggregation (one forward's count, read just after
     it); then forward ms (p50, CUDA events) beside its bound (model
     FLOPs over the float32 rate, TF32 off, or bytes over HBM), peak
     memory, device launches, card busy time and segment_reduce's card
     time (profiler). TF32 is off throughout.
 12. training — (a) segment_reduce under autograd at the GraphCast
     processor's shape (float32, bf16) and at DeepFM's train_batch bags,
     with dropped ids: the forward bit-equal to the kernel's without a
     gradient, the backward equal to the plain version's (a gather); (b)
     one float32 train step of each reduced LM arch (also with two
     micro-batches) and of gemma3-1b at full width with 2 layers, card
     against the CPU port (metrics within 1e-4, every updated leaf within
     1e-5); 30 steps of `python -m repro_torch.launch.train --arch
     olmoe-1b-7b` (its main) lowering the mean loss; a crash after step 6
     and a restart (run_with_restarts) bit-equal to the uninterrupted run;
     (c) gemma3-1b at full width and depth in bf16, remat on, batch 2 x
     4096: 6 Trainer steps, every one finite, with async checkpoints every
     3 steps and the last restored bit for bit (host snapshot ms, write and
     restore seconds); (d) each GNN arch's reduced config (MeshGraphNet and
     GraphCast also with remat, GraphCast streamed) and DeepFM's small
     config: every gradient leaf card against the CPU port (relative L2
     1e-4) and one registry train step (params within 1e-5); (e) train
     steps of gat-cora on full_graph_sm, schnet on molecule, MeshGraphNet
     and GraphCast (remat) at minibatch_lg's dims, DeepFM at train_batch
     with its full table. Every GNN and DeepFM step launches segment_reduce
     exactly as often as its aggregations need (again for each
     rematerialized block). Each timed config: step ms (p50, CUDA events)
     beside its bound, tokens or examples a second, peak memory, device
     launches and card busy ms a step (profiler), the optimizer's ms apart.
 13. model exchanges across ranks — 4 ranks spawned once, sharing the card
     over gloo (their exchanges staged through the host; NCCL refuses two
     ranks on one card), mesh (1, 4) over ("data", "model"), every path on
     every rank: (a) olmoe-1b-7b at full width and depth in bf16 with its
     64 experts over the ranks (ep = 4, `init_params(ranks=)`), 2 x 1024
     prompt tokens and 16 greedy ones through Generator, at the published
     capacity factor (its drops logged) and at 8 (none, at ep = 4 or 1),
     the decode with sync debugging at "error" (the gloo exchanges
     excepted: gloo waits for its host copies); rank 0 against the
     one-process port at ep = 1 on the card (tokens equal, or a flip only
     at a top-two gap within the bf16 bound; logits within it), and 2
     layers in float32 (TF32 off) within 1e-4; (b) DeepFM at its published
     config with the table's 33,540,000 rows over the ranks: the sharded
     lookup bit-equal to table[ids] at serve_p99 and serve_bulk and on a
     skewed stream past the reference's capacity, the table's gradient
     through it within 1e-6 of the scatter-add, every rank's logits within
     1e-5 of the one-process forward on the card; (c) MeshGraphNet (15 x
     128) on a graph of ogb_products' d_feat and mean degree (2^17 nodes)
     and GraphCast (16 x 512, streamed) on a 4,096-node grid, node-sharded
     with the shuffle, bf16 and remat as the registry binds them: the
     first forward with no host sync but the exchanges', segment_reduce
     launched once per aggregation on every rank, each route's owner-side
     Reduce in that forward held to the plain version on the rows the
     rank received (float32 within 1e-5 / 1e-4 of the float64 sum, bf16
     within 2^-8 / 1e-4), outputs finite; in float32 the ranks' node
     outputs within 1e-4 of the one-process port.
     Per rank: ms (CUDA events), peak memory, the bytes each call hands
     the collectives, and the collectives' share of a call (in a run with
     a synchronize around each collective). Any rank's failure or hang
     fails the phase.
 14. training across ranks — 4 ranks sharing the card over gloo, spawned
     once, each part's meshes built on the one group. (a) The reference's
     mesh program's reduced MoE LM (tests/distributed/lm_mesh_prog.py) in
     float32 on meshes (data 2, model 2), (4, 1) and (1, 4), 2 steps
     that clip: loss, grad_norm and the params (relative L2 of the tree)
     within 1e-5 of the one-process step on the card, each leaf within
     1e-3 of its norm. (b) gemma3-1b at full width, 13 of its 26 layers
     (all 26 with --train-ranks-nccl), bf16, remat, global batch 4 x
     1024: 2 steps at (data 4) with ZeRO-1, step 1's checkpoint written
     across the ranks and restored in one process, whose step 2 is held
     to the ranks'; 1 step at (data 2, model 2) with the sequence cut:
     loss within 2e-3 and grad_norm within 1e-2 of one card's; step ms,
     peak, the bytes handed to the collectives and their share a rank.
     (c) qwen2.5-32b at full width with its FSDP, 1 layer, 4 x 512,
     (data 4), 1 step: the loss and grad_norm as (b)'s. (d) phase 13's
     graphs (MeshGraphNet's cut to 2^15 nodes), float32, 1 step:
     segment_reduce once per aggregation and again in the remat on every
     rank, each route's Reduce held to the plain version, params and
     grad_norm within 1e-5 of one card's. (e) DeepFM at its published
     config (8,385,000 table rows a rank) and train_batch, 1 step, m and
     v as `_opt_specs` cuts them: the updated rows within 1e-6 of one
     card's.
 15. the cells and the dry-run — `configs/registry.build_cell`: (a) the
     `mapsq` cells for real, every shard of the production mesh a local
     shard of one ShardMesh on the card (join_1m and join_16m on 16 x 16,
     join_1m on 2 x 16 x 16), the cell's own step and capacities on its
     seeded relations at full row counts: on 16 x 16 no overflow, the
     per-shard totals a NumPy count's, the rows a plain-torch oracle's as
     a multiset; on 2 x 16 x 16, where the reference's capacities
     overflow the pod stage, the flag and the rows lost logged and the
     rows produced a sub-multiset of the oracle's; one pair_expand launch
     a join; warm p50 (CUDA events, 5 runs), peak, device launches; (b) `python -m repro_torch.launch.dryrun`
     of gemma3-1b train_4k, graphcast ogb_products, deepfm serve_bulk and
     mapsq join_16m on both meshes (a CPU process beside (a) and (c)),
     each record's terms and bottleneck; (c) gat-cora full_graph_sm,
     deepfm serve_p99, gemma3-1b train_4k (batch 1 x 4096) and mapsq
     join_1m on a one-rank mesh, one step on the card under the counters:
     its FLOPs, argument bytes and kernel calls the meta trace's exactly,
     its max_memory_allocated logged beside the trace's temp + argument
     bytes.
 16. the engine's and server's modes, on phase 5's store: (a) J1 and J2
     on the legacy greedy planner (optimize=False) and on the optimizer:
     rows equal each other and `sparql/baseline.reference_rows` (over the
     triples of the queries' constant predicates), the optimized bucket
     strictly smaller, a warm repeat 1 dispatch and 0 compiles with one
     pair_expand launch a join, warm p50 (CUDA events); (b) the eager
     engine with double-on-overflow sizing (compiled=False,
     exact_count_pass=False) on phase 5's queries: rows equal the default
     engine's as multisets, no count pass, pair_expand launched on every
     MR join attempt, retries logged; at scale 2 the card's retries, rows
     and stats the CPU port's, and MemoryError past max_capacity 1 (the
     first overflow) on both; (c) one engine behind the default server, the synchronous one
     (decode_workers=0) and the unbatched one (batch_execution=False),
     two rounds of bursts of phase 7's texts: rows equal the
     single-query rows, no stacked dispatch unbatched, no decode pool
     synchronous; round 2's p50 of each.
 17. summary — the stacked-forms line, the kernels line (each kernel with
     the cells that reach it), the card line, then the result line.

Each of the paths of phases 3, 5, 6, 7, 8, 9, 11, 12, 13, 14, 15 and 16
runs with the launch counts set to 0 just before it and read just after
(in phases 9, 13 and 14 on each rank); the kernels line reports each
kernel's launches from the path that runs it (segment_reduce's: the
kernel API's, phase 11's, 12's, 13's and 14's, also apart;
pair_expand's: phase 5's, 15's mapsq joins and 16's modes, also apart).

Needs the repository's src/ beside it and one CUDA card; exits non-zero
without them.

    python3 chip_smoke.py --lm-only

runs phase 10 alone (no kernel build, no result line).

    python3 chip_smoke.py --gnn-only

runs the build and phase 11 alone (no result line).

    python3 chip_smoke.py --train-only

runs the build and phase 12 alone (no result line).

    python3 chip_smoke.py --exchanges-only

runs the build and phase 13 alone (no result line).

    python3 chip_smoke.py --exchanges-nccl

runs the build and phase 13 with one NCCL rank a card, on a host of
several cards (4 H100s joined by NVLink): (a) and (b) at the same shapes, and
MeshGraphNet alone at ogb_products' registry dims (2,449,408 nodes,
61,859,328 edge slots, bf16, remat, the shuffle; outputs finite). No
result line.

    python3 chip_smoke.py --train-ranks-only

runs the build and phase 14 alone (no result line).

    python3 chip_smoke.py --train-ranks-nccl

runs the build and phase 14's (b) with one NCCL rank on each of 4 cards,
at full depth and train_4k's sequence (global batch 4 x 4096); the
one-card reference takes it in two micro-batches. No result line.

    python3 chip_smoke.py --cells-only [--dryrun-all]

runs the build and phase 15 alone (no result line); with --dryrun-all
its dry-run covers every cell on both meshes (84 records under
build/dryrun/).

    python3 chip_smoke.py --modes-only

runs the build and phase 16 alone, after generating phase 5's store and
the default engine's rows on it (no result line).

    python3 chip_smoke.py --kernels-only [--src OTHER/src]

runs phases 1-2 alone, on this checkout's kernels or another tree's (an
unpacked earlier commit), so two versions are timed in one call on one
card. Another tree's failed checks are logged, not fatal, and a check
whose premise it lacks (the stable radix path's `stable_at`, the device
launch counts) is not made.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import re
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


def clear_launches(kernels) -> None:
    """Set the launch counts (and, where the tree keeps them, the device
    launch counts) to 0."""
    kernels.LAUNCHES.clear()
    getattr(kernels, "DEVICE_LAUNCHES", {}).clear()


def fail(msg: str) -> None:
    raise SystemExit(f"FAILED: {msg}")


# False only for --kernels-only on another tree: its failed checks are
# logged and the timing goes on (nothing is claimed for that tree)
STRICT = True


def check(cond: bool, msg: str) -> None:
    if not cond:
        if STRICT:
            fail(msg)
        log(f"CHECK FAILED (another tree, not fatal): {msg}")


# -- timing --------------------------------------------------------------------


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around `iters` calls
    that the host queued behind a sleeping kernel: the host's launch path
    (ctypes, allocation, Python) runs ahead and does not pace the card,
    which it would for calls shorter than their enqueue. A call that waits
    for the card (the plain versions' host syncs) is timed with its wait."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t  # one call's enqueue
    torch.cuda.synchronize()
    # twice the enqueue of all `iters` calls, at ~2e9 cycles/s, <= 0.2 s
    torch.cuda._sleep(int(min(0.2, 2 * iters * host_s) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def enqueue_ms(fn, iters: int = 20) -> float:
    """Host time of one call without waiting for the card: where it is
    near the device time, the host's launch path sets the pace."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t
    torch.cuda.synchronize()
    return elapsed / iters * 1e3


def device_breakdown(fn, calls: int = 5):
    """Device ms and launches per call of each kernel `fn` runs, from a
    torch.profiler (CUPTI) trace; "not measured" where the trace holds
    no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = (getattr(ev, "device_time_total", 0)
              or getattr(ev, "cuda_time_total", 0))
        if us:
            name = re.search(r"[a-z][a-z_]*_kernel(<[^>]*>)?", ev.key)
            key = name.group(0) if name else ev.key[:40]
            ms, n = out.get(key, (0.0, 0.0))  # kernels sharing a short name
            out[key] = (round(ms + us / 1e3 / calls, 6),
                        n + ev.count / calls)
    return out or "not measured"


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

    def device_launches(name, before=None):
        """The device launches a launcher reported (a tree without the
        count gives None)."""
        counts = getattr(kernels, "DEVICE_LAUNCHES", None)
        if counts is None:
            return None
        return counts[name] if before is None else counts[name] - before

    def record(name, shape, err, run, plain, b, algo_ops, lib, source,
               replaces, exact=True, primary=True, iters=20):
        """Time and log one shape's row: the kernel's call `run`, its plain
        version `plain` and one library call `lib` (either may be None).
        Beside each card time, the host's enqueue of one call and the
        call's cost, the larger of the two: a launch-bound call costs its
        enqueue on the main path. The primary shape's row (the last one
        recorded with primary=True) goes into the kernels line."""
        b_ms, b_by = b
        k_ms, k_enq = time_ms(run, iters=iters), enqueue_ms(run)
        p_ms = None if plain is None else time_ms(plain)
        lib_ms, lib_enq = ((None, None) if lib is None else
                           (time_ms(lib, iters=iters), enqueue_ms(lib)))
        fmt = lambda x: "null" if x is None else f"{x:.6f}"  # noqa: E731
        log(f"kernel {name} {shape}: max_abs_err={err} kernel_ms={k_ms:.6f} "
            f"host_enqueue_ms={k_enq:.6f} cost_ms={max(k_ms, k_enq):.6f} "
            f"plain_ms={fmt(p_ms)} bound_ms={b_ms:.9f} ({b_by}) "
            f"kernel_algorithm_ops={algo_ops} library_ms={fmt(lib_ms)} "
            f"library_enqueue_ms={fmt(lib_enq)} library_cost_ms="
            f"{fmt(None if lib is None else max(lib_ms, lib_enq))}")
        if exact:
            check(err == 0, f"{name} {shape} differs from its plain version")
        if not primary:
            return
        out[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms,
        }

    # pair_expand at the engine's largest buckets (the kernels line), then
    # the merge path's edges: 90% zero counts with a run of zero-count rows
    # far longer than a block's 2048 merge positions, a total of a third
    # of the capacity (two thirds of the blocks wholly past it), a total
    # above the capacity; then every (n_left, capacity) the full-scale
    # phase gives it, with that join's total as matches at random rows,
    # single and stacked at the serving phase's width
    n_left, cap = 1 << 20, 1 << 22
    pe_cases = []
    counts = torch.randint(0, 7, (n_left,), generator=gen, dtype=torch.int32)
    pe_cases.append(("uniform counts 0-6", counts, cap, 0))
    sparse = torch.randint(1, 7, (n_left,), generator=gen, dtype=torch.int32)
    sparse *= torch.rand(n_left, generator=gen) < 0.1
    sparse[1 << 18:(1 << 18) + 100_000] = 0
    pe_cases.append(("90% zero counts, a zero run of 100000", sparse, cap, 0))
    third = torch.randint(0, 3, (n_left,), generator=gen, dtype=torch.int32)
    pe_cases.append(("total = capacity/3", third, 3 * int(third.sum()), 0))
    over = torch.randint(0, 7, (n_left,), generator=gen, dtype=torch.int32)
    pe_cases.append(("total > capacity", over, int(over.sum()) * 3 // 4, 0))
    for what, n_left, cap, total, lanes in (
            ("Q1 join 1", 1 << 20, 16, 13, 16),
            ("Q2 join 1", 1 << 18, 256, 133, 16),
            ("Q2 join 2", 256, 1024, 735, 16),
            ("Q4 join 1", 1 << 18, 16, 11, 16),
            ("Q4 join 2", 16, 16, 11, 16),
            ("Q7 join 1", 1 << 22, 32, 23, 16),
            ("Q7 join 2", 32, 32, 23, 16),
            ("Q9 join 1", 1 << 18, 1 << 18, 217_222, 4),
            ("Q9 join 2", 1 << 18, 1 << 21, 1_228_241, 4),
            ("Q9 join 3", 1 << 21, 1 << 18, 254_442, 4),
            ("Q9 join 4", 1 << 18, 1 << 18, 254_442, 4)):
        counts = torch.stack([
            torch.bincount(torch.randint(0, n_left, (total,), generator=gen),
                           minlength=n_left).int()
            for _ in range(lanes)])
        pe_cases.append((f"main path, {what}", counts, cap, lanes))
    search_at = getattr(pek, "search_at", None)  # older trees: one path

    def pe_path(lanes, cap):
        return "one" if search_at is None else (
            "search" if search_at(lanes, cap) else "merge")

    for what, counts, cap, lanes in pe_cases:
        stack = counts if lanes else None
        counts = counts[0] if lanes else counts
        n_left = counts.shape[0]
        prefix = torch.cumsum(counts, 0, dtype=torch.int32).to(dev)
        counts = counts.to(dev)
        total = int(prefix[-1])
        got = pek.pair_expand_cuda(prefix, counts, cap)
        want = per.pair_expand(prefix, counts, cap)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        slots = torch.arange(cap, dtype=torch.int32, device=dev)
        shape = f"n_left={n_left} capacity={cap} total={total} ({what})"
        run = lambda: pek.pair_expand_cuda(prefix, counts, cap)  # noqa: E731

        def fill(out=got):  # a practical write rate: the outputs' bytes alone
            out[0].fill_(1), out[1].fill_(2), out[2].fill_(True)

        log(f"kernel pair_expand {shape}: path {pe_path(1, cap)}; fill_ms="
            f"{time_ms(fill):.6f} (three torch fills of the outputs); device "
            "ms, launches per call by "
            f"kernel {device_breakdown(run)}")
        record(
            "pair_expand", shape, err, run,
            lambda: per.pair_expand(prefix, counts, cap),
            # i, off (int32) and valid (bool) out; prefix and counts read
            # once, of the rows the slots can land on (each slot's row and
            # the one before it: all of them unless the capacity is far
            # below n_left); a merge of those with the slots is one compare
            # per element
            bound(8 * min(n_left, 2 * cap) + 9 * cap,
                  min(n_left, 2 * cap) + cap),
            # search: a probe per slot and halving; merge: a step per row
            # and per slot
            cap * n_left.bit_length() if pe_path(1, cap) == "search"
            else n_left + cap,
            lambda: torch.searchsorted(prefix, slots, right=True),
            "src/repro_torch/kernels/pair_expand/csrc/pair_expand.cu",
            "src/repro/kernels/pair_expand/kernel.py:25",
            primary=what.startswith("uniform"),
        )
        del got, want, slots
        if not lanes:
            continue
        # the stacked form the serving phase launches: one call for
        # `lanes` lanes, against that many single calls
        s_prefix = torch.cumsum(stack, 1, dtype=torch.int32).to(dev)
        s_counts = stack.to(dev)
        lane_rows = [(s_prefix[w], s_counts[w]) for w in range(lanes)]
        stacked = pek.pair_expand_cuda(s_prefix, s_counts, cap)
        singles = [pek.pair_expand_cuda(p_, c_, cap) for p_, c_ in lane_rows]
        torch.cuda.synchronize()
        check(all(max_abs_err([o[w] for o in stacked], singles[w]) == 0
                  for w in range(lanes)),
              f"stacked pair_expand {shape} differs from its single calls")
        run = lambda: pek.pair_expand_cuda(s_prefix, s_counts, cap)  # noqa: E731

        def run_singles():
            return [pek.pair_expand_cuda(p_, c_, cap) for p_, c_ in lane_rows]

        log(f"kernel pair_expand {shape} stacked lanes={lanes}: path "
            f"{pe_path(lanes, cap)}; kernel_ms={time_ms(run):.6f} "
            f"host_enqueue_ms={enqueue_ms(run):.6f} "
            f"singles_ms={time_ms(run_singles):.6f}")
        del stacked, singles, s_prefix, s_counts, lane_rows

    # match_layout at S1's shape and the optimizer's dense cap (the kernels
    # line), both sides of its two paths' threshold C (the largest square
    # on the compare path and the next one), shapes the optimizer's cap
    # admits (2^20 left rows against 4 right keys, every left key
    # matching; the transpose; 2^11 x 2^11) and Q9's largest join, 2^21 x
    # 2^18 (the forced matrix backend), with both invalid-row sentinels.
    # Bit for bit against the plain version where its dense compares stay
    # under 2^26, elsewhere against the sorted oracle.
    sorted_at = getattr(smk, "sorted_at", None)  # older trees: one path
    oracle = getattr(smr, "match_layout_sorted", None)
    square = 14654  # an older tree's stand-in for the compare path's edge
    if sorted_at is not None:  # the largest n with n x n on the compare path
        lo, hi = 1, 1 << 16
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (lo, mid - 1) if sorted_at(mid, mid) else (mid, hi)
        square = lo
    ml_shapes = [(1024, 64, "S1"), (4096, 1024, "dense cap"),
                 (square, square, "largest compare square"),
                 (square + 1, square + 1, "next square"),
                 (1 << 20, 4, "every left key matching"),
                 (4, 1 << 20, "transpose"), (1 << 11, 1 << 11, "square"),
                 (1 << 21, 1 << 18, "Q9 join 3")]
    if sorted_at is None:  # the quadratic kernel takes minutes there
        ml_shapes = ml_shapes[:-1]
    for n_l, n_r, what in ml_shapes:
        if what == "every left key matching":
            lk = torch.randint(0, 4, (n_l,), generator=gen, dtype=torch.int32)
            rk = torch.arange(n_r, dtype=torch.int32)
        else:
            hi = 97 if n_l * n_r <= 1 << 22 else min(n_l, n_r)
            lk = torch.randint(0, hi, (n_l,), generator=gen, dtype=torch.int32)
            rk = torch.randint(0, hi, (n_r,), generator=gen, dtype=torch.int32)
            lk[-max(1, n_l // 8):] = int_max  # invalid-left sentinels
            rk[-max(1, n_r // 8):] = int_max - 1  # invalid-right sentinels
        lk, rk = lk.to(dev), rk.to(dev)
        before = device_launches("match_layout")
        got = smk.match_layout_cuda(lk, rk)
        per_call = device_launches("match_layout", before)
        dense = n_l * n_r <= 1 << 26
        if dense:
            want, against = smr.match_layout(lk, rk), "the plain version"
        elif oracle is not None:
            want, against = oracle(lk, rk), "the sorted oracle"
        else:
            want, against = None, "nothing (no oracle in this tree)"
        torch.cuda.synchronize()
        err = 0 if want is None else max_abs_err(got, want)
        sort_path = sorted_at is not None and sorted_at(n_l, n_r)
        compares = 2 * n_l * n_r + n_l * n_l // 2
        n = n_l + n_r
        run = lambda: smk.match_layout_cuda(lk, rk)  # noqa: E731
        log(f"kernel match_layout n_l={n_l} n_r={n_r} ({what}): path "
            f"{'sorted' if sort_path else 'compare'}; device launches per "
            f"call {per_call}; compare count {compares}; checked against "
            f"{against}; device ms, launches per call by kernel "
            f"{device_breakdown(run) if sort_path else 'one kernel'}")
        record(
            "match_layout", f"n_l={n_l} n_r={n_r} ({what})", err, run,
            (lambda: smr.match_layout(lk, rk)) if dense else None,
            # keys read once, four int32 outputs written once; a sort of
            # both sides and a merge give every output
            bound(4 * (n_l + n_r) + 4 * (3 * n_l + n_r), n_log_n(n)),
            # sort-and-search: 4 radix passes (a digit taken twice per key)
            # and a binary search per output count; compare path: eq and
            # lt per (i, j), earlier-equal left keys per row pair (at most:
            # blocks with no match skip that pass)
            8 * n + (3 * n_l + 2 * n_r) * max(1, n.bit_length())
            if sort_path else compares,
            None,
            "src/repro_torch/kernels/spmm_join/csrc/match_layout.cu",
            "src/repro/kernels/spmm_join/kernel.py:29",
            primary=what == "dense cap",
            iters=20 if sort_path or compares <= 1 << 30 else 3,
        )
        del got, want, lk, rk

    # sort_ranks over the right side of a matrix join: S1's 64 keys, the
    # dense cap's sides, both sides of its two paths' threshold T (the
    # compare path up to T, the radix path above: 2^14, T, T + 1, 2^15), a
    # right side of 2^18 rows beside a tiny left side (legal under the
    # optimizer's cap) and 2^20 + 3. Heavy ties, INT32_MIN and both
    # invalid-row sentinels. Bit for bit against the plain version where
    # its quadratic blocks are quick, and everywhere the inverse of the
    # stable argsort. n = 4096 goes into the kernels line.
    radix_at = getattr(smk, "radix_at", None)  # older trees: one path
    threshold = 20480
    if radix_at is not None:  # the largest n on the compare path
        lo, hi = 1, 1 << 21
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (lo, mid - 1) if radix_at(mid) else (mid, hi)
        threshold = lo
    sr_sizes = [64, 1024, 4096, 1 << 14, threshold, threshold + 1, 1 << 15,
                1 << 18, (1 << 20) + 3]
    if radix_at is None:  # a quadratic kernel: 2^20 keys take seconds
        sr_sizes = sr_sizes[:-1]
    for n in sr_sizes:
        keys = torch.randint(0, max(2, n // 64), (n,), generator=gen,
                             dtype=torch.int32)
        keys[torch.rand(n, generator=gen) < 0.05] = -(2**31)
        keys[torch.rand(n, generator=gen) < 0.1] = int_max  # invalid left
        keys[torch.rand(n, generator=gen) < 0.1] = int_max - 1  # invalid right
        keys = keys.to(dev)
        before = device_launches("sort_ranks")
        got = smk.sort_ranks_cuda(keys)
        per_call = device_launches("sort_ranks", before)
        perm = torch.argsort(keys, stable=True)
        quick_plain = n <= threshold + 1
        want = smr.sort_ranks(keys) if quick_plain else None
        torch.cuda.synchronize()
        check(torch.equal(got[perm].cpu(), torch.arange(n, dtype=torch.int32)),
              f"sort_ranks n={n} is not the inverse of the stable argsort")
        radix = radix_at is not None and radix_at(n)
        run = lambda: smk.sort_ranks_cuda(keys)  # noqa: E731
        log(f"kernel sort_ranks n={n}: path "
            f"{'radix' if radix else 'compare'}; device launches per call "
            f"{per_call}; checked against "
            f"{'the plain version and ' if quick_plain else ''}the inverse of "
            f"the stable argsort; device ms, launches per call by kernel "
            f"{device_breakdown(run)}")
        record(
            "sort_ranks", f"n={n}",
            max_abs_err([got], [want]) if quick_plain else 0,
            run, (lambda: smr.sort_ranks(keys)) if quick_plain else None,
            bound(8 * n, n_log_n(n)),  # a stable comparison sort
            # radix: 4 passes, a digit taken twice per key (count, rank);
            # compare path: a compare per key pair
            8 * n if radix else n * n,
            lambda: torch.argsort(keys, stable=True),
            "src/repro_torch/kernels/spmm_join/csrc/sort_ranks.cu",
            "src/repro/kernels/spmm_join/kernel.py:57",
            primary=n == 4096, iters=20 if n <= 1 << 18 else 5,
        )
        del got, want, perm

    # bitonic_sort: the reference benchmark's n, the one-block tile's edge
    # (the largest n one launch sorts, and one more: the radix path), twice
    # the tile, the reference kernel's largest block, and the engine's
    # largest bucket plus 3 (not a power of two). Above one tile the sort
    # is stable, so its payloads equal the plain version's.
    stable_at = getattr(bsk, "stable_at", lambda n: False)  # older trees
    for n in (4096, 8192, 8193, 16384, 1 << 19, (1 << 22) + 3):
        keys = torch.randint(-(2**31), int_max, (n,), generator=gen,
                             dtype=torch.int32)
        keys[: n // 2] %= 1 << 16  # duplicate keys
        keys[torch.rand(n, generator=gen) < 0.001] = int_max
        vals = torch.randint(-(2**31), int_max, (n,), generator=gen,
                             dtype=torch.int32)
        keys, vals = keys.to(dev), vals.to(dev)
        before = device_launches("bitonic_sort")
        gk, gv = bsk.sort_pairs_cuda(keys, vals)
        per_call = device_launches("bitonic_sort", before)
        wk, wv = bsr.sort_pairs(keys, vals)
        torch.cuda.synchronize()
        check(torch.equal(pair_multiset(gk, gv), pair_multiset(wk, wv)),
              f"bitonic_sort n={n}: (key, payload) multisets differ")
        stable = stable_at(n)
        if stable:
            check(torch.equal(gv, wv),
                  f"bitonic_sort n={n}: payloads differ from the stable sort")
        log(f"kernel bitonic_sort n={n}: device launches per call "
            f"{per_call}; payloads "
            f"{'equal the plain version' if stable else 'as a multiset'}; "
            "device ms, launches per call by kernel "
            f"{device_breakdown(lambda: bsk.sort_pairs_cuda(keys, vals))}")
        record(
            "bitonic_sort", f"n={n}", max_abs_err([gk], [wk]),
            lambda: bsk.sort_pairs_cuda(keys, vals),
            lambda: bsr.sort_pairs(keys, vals),
            # keys and payloads read once and written once; a comparison
            # sort's n log2 n compares
            bound(16 * n, n_log_n(n)),
            # radix: 4 passes, a digit taken twice per key (count, rank);
            # network: its compares over its power-of-two span
            8 * n if stable else (1 << (n - 1).bit_length()) // 2
            * ((n - 1).bit_length() * ((n - 1).bit_length() + 1) // 2),
            lambda: torch.sort(keys),
            "src/repro_torch/kernels/bitonic_sort/csrc/bitonic_sort.cu",
            "src/repro/kernels/bitonic_sort/kernel.py:42",
        )

    # segment_reduce: the reference benchmark's shape, the reference
    # kernel's largest segment count in float32 and bfloat16, the same
    # with segment 7 holding half the rows (power-law segment sizes, as
    # GNN message passing and EmbeddingBag see), and 16x the segments;
    # then the shapes phase 11's models give it: GraphCast's processor
    # aggregation at minibatch_lg (297,472 edges x 512 into 42,496 mesh
    # nodes, float32, the kernels line's row, and bfloat16), its m2g
    # aggregation (168,960 x 512 into 169,984 grid nodes) and DeepFM's
    # embedding bag at serve_bulk (10,223,616 rows of 10 and of 1, one row
    # a bag). float32 is held to the plain version's sum in float64 (the
    # exact sum: at the skewed shape the float32 plain version's own
    # rounding exceeds the tolerance) and, at uniform shapes, to the
    # float32 plain version; bfloat16 to the float32 result. Two calls
    # give equal bits.
    def seg_case(label, n, d, segs, dtype, ids, primary, hot=0):
        data32 = torch.randn(n, d, generator=gen).to(dev)
        data = data32.to(dtype)
        before = device_launches("segment_reduce")
        got = srk.sorted_segment_sum_cuda(data, ids, segs)
        per_call = device_launches("segment_reduce", before)
        again = srk.sorted_segment_sum_cuda(data, ids, segs)
        torch.cuda.synchronize()
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        shape = f"n={n} d={d} segments={segs} {dtype} {label}"
        check(torch.equal(got.view(bits), again.view(bits)),
              f"segment_reduce {shape}: two calls differ in their bits")
        if dtype == torch.float32:
            exact = srr.sorted_segment_sum(data.double(), ids, segs)
            err = float_err(got, exact, 1e-5, 1e-4)
            plain = srr.sorted_segment_sum(data, ids, segs)
            plain_err = float((plain.double() - exact).abs().max())
            if not hot:  # the float32 plain version within the tolerance
                float_err(got, plain, 1e-5, 1e-4)
            del exact, plain
        else:  # bf16 against the float32 result, the reference's bounds:
            # of the same bf16 inputs, and at uniform shapes (as before)
            # of the float32 data they were rounded from (over 2^19 rows
            # that rounding alone exceeds the bounds)
            err = float_err(got, srr.sorted_segment_sum(data.float(), ids,
                                                         segs), 5e-2, 0.3)
            plain_err = float((srr.sorted_segment_sum(data32, ids, segs)
                               - got.float()).abs().max())
            if not hot:
                float_err(got, srr.sorted_segment_sum(data32, ids, segs),
                          5e-2, 0.3)
        del got, again, data32
        log(f"kernel segment_reduce {shape} hot_segment_rows={hot}: device "
            f"launches per call {per_call}; two calls bit-equal; max abs "
            f"error of the float32 plain version from the float64 sum "
            f"(float32), of the kernel from the float32 data's sum "
            f"(bfloat16): {plain_err}; device ms, launches per call by "
            f"kernel "
            f"{device_breakdown(lambda: srk.sorted_segment_sum_cuda(data, ids, segs))}")
        size = data.element_size()
        record(
            "segment_reduce", f"{shape} hot_segment_rows={hot}", err,
            lambda: srk.sorted_segment_sum_cuda(data, ids, segs),
            lambda: srr.sorted_segment_sum(data, ids, segs),
            # data and ids read once, out written once; n*d adds
            bound(n * d * size + 4 * n + segs * d * size, n * d),
            n * d,
            lambda: torch.zeros(segs, d, dtype=dtype, device=dev)
            .index_add_(0, ids, data),
            "src/repro_torch/kernels/segment_reduce/csrc/segment_sum.cu",
            "src/repro/kernels/segment_reduce/kernel.py:25",
            exact=False, primary=primary,
        )

    def random_ids(n, segs, hot=0):
        ids = torch.randint(0, segs, (n - hot,), generator=gen,
                            dtype=torch.int32)
        ids = torch.cat([ids, torch.full((hot,), 7, dtype=torch.int32)])
        return torch.sort(ids).values.to(dev)

    skew = 1 << 19
    for n, d, segs, dtype, hot in ((2048, 64, 128, torch.float32, 0),
                                   (1 << 20, 128, 4096, torch.float32, 0),
                                   (1 << 20, 128, 4096, torch.bfloat16, 0),
                                   (1 << 20, 128, 4096, torch.float32, skew),
                                   (1 << 20, 128, 4096, torch.bfloat16, skew),
                                   (1 << 20, 128, 65536, torch.float32, 0)):
        seg_case("skew" if hot else "uniform", n, d, segs, dtype,
                 random_ids(n, segs, hot), primary=False, hot=hot)
    mesh_ids = random_ids(297_472, 42_496)
    for dtype in (torch.bfloat16, torch.float32):  # float32: the kernels line
        seg_case("graphcast processor", 297_472, 512, 42_496, dtype,
                 mesh_ids, primary=dtype == torch.float32)
    seg_case("graphcast m2g", 168_960, 512, 169_984, torch.float32,
             random_ids(168_960, 169_984), primary=False)
    # a rank's owner-side Reduce of MeshGraphNet's shuffle scatter, in
    # phases 13 and 14 (2^17 nodes over 4 ranks: 818,442 rows received
    # into the rank's 32,768 nodes), bf16 as the registry binds it and
    # float32 as phase 14 trains it
    route_ids = random_ids(818_442, 32_768)
    for dtype in (torch.bfloat16, torch.float32):
        seg_case("meshgraphnet rank route", 818_442, 128, 32_768, dtype,
                 route_ids, primary=False)
    bags = torch.arange(10_223_616, dtype=torch.int32, device=dev)
    for d in (10, 1):
        seg_case("deepfm bag serve_bulk", 10_223_616, d, 10_223_616,
                 torch.float32, bags, primary=False)
    clear_launches(kernels)  # comparison launches do not count
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
    # the radix path's lane axis (above the compare path's threshold; a
    # ragged length, so lane rows are not 16-byte aligned)
    rk = keys(40_001, int_max - 1)
    rk[:, :100] = -(2**31)
    cases.append(("sort_ranks", lambda x: (smk.sort_ranks_cuda(*x),),
                  (rk,), "n=40001 sentinels, INT32_MIN (radix path)"))
    # match_layout's sort-and-search path (ragged lengths too)
    lk = keys(40_001, int_max)
    lk[:, :100] = -(2**31)
    cases.append(("match_layout", lambda x: smk.match_layout_cuda(*x),
                  (lk, keys(37, int_max - 1)),
                  "n_l=40001 n_r=37 sentinels, INT32_MIN (sorted path)"))
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
    clear_launches(kernels)  # the kernel-API path's launches start here
    sk, sv = bso.sort_pairs(keys, vals)
    order = bso.argsort_i32(keys)
    seg = sro.sorted_segment_sum(data, ids, 128)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    device = dict(kernels.DEVICE_LAUNCHES)
    wk, wv = bsr.sort_pairs(keys, vals)
    check(torch.equal(sk, wk)
          and torch.equal(pair_multiset(sk, sv), pair_multiset(wk, wv)),
          "sort_pairs differs from its plain version")
    check(torch.equal(keys[order.long()], wk)
          and torch.equal(torch.sort(order).values, vals),
          "argsort_i32 is not a sorting permutation")
    float_err(seg, srr.sorted_segment_sum(data, ids, 128), 1e-5, 1e-4)
    log(f"kernel API: sort_pairs, argsort_i32, sorted_segment_sum equal "
        f"their plain versions; launches {launches}; device launches "
        f"{device}")
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


def kernel_shapes(pq) -> dict[str, list]:
    """The shapes one run of `pq` gives pair_expand ((lanes,) n_left,
    capacity per launch), sort_ranks ((lanes,) n per launch) and
    match_layout ((lanes,) n_l, n_r and its path per launch), read by
    wrapping their bindings for the run."""
    from repro_torch.kernels.pair_expand import kernel as pek
    from repro_torch.kernels.spmm_join import kernel as smk

    seen: dict[str, list] = {"pair_expand": [], "sort_ranks": [],
                             "match_layout": []}
    pair_expand, sort_ranks = pek.pair_expand_cuda, smk.sort_ranks_cuda
    match_layout = smk.match_layout_cuda

    def pe(prefix, counts, capacity):
        seen["pair_expand"].append((*prefix.shape, capacity))
        return pair_expand(prefix, counts, capacity)

    def sr(keys):
        seen["sort_ranks"].append(tuple(keys.shape))
        return sort_ranks(keys)

    def ml(lk, rk):
        n_l, n_r = lk.shape[-1], rk.shape[-1]
        seen["match_layout"].append(
            (*lk.shape[:-1], n_l, n_r,
             "sorted" if smk.sorted_at(n_l, n_r) else "compare"))
        return match_layout(lk, rk)

    pek.pair_expand_cuda, smk.sort_ranks_cuda = pe, sr
    smk.match_layout_cuda = ml
    try:
        pq.run()
    finally:
        pek.pair_expand_cuda, smk.sort_ranks_cuda = pair_expand, sort_ranks
        smk.match_layout_cuda = match_layout
    return seen


def full_scale_phase(dev) -> dict:
    from repro_torch import kernels
    from repro_torch.sparql import lubm
    from repro_torch.sparql.engine import QueryEngine

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
    for name in names:  # after the count: one more warm run per query
        report[name]["kernel_shapes"] = kernel_shapes(engine.prepare(texts[name]))
        log(f"  kernel shapes {name}: {report[name]['kernel_shapes']}")

    t = time.perf_counter()
    oracle = {name: oracle_rows(store, texts[name]) for name in names}
    for name in names:
        check(id_rows(store, texts[name], cpu_rows[name]) == oracle[name],
              f"{name}: rows != hash-join oracle")
    log(f"full scale: all {len(names)} queries equal the hash-join oracle "
        f"({time.perf_counter() - t:.1f} s, host)")
    return {"launches": launches, "peak_bytes": peak, "queries": report,
            "store": store, "texts": texts, "cpu_rows": cpu_rows,
            "card_rows": card_rows, "oracle": oracle}


def id_rows(store, text: str, rows) -> set[tuple]:
    """Decoded result rows as the set of id tuples the oracle gives."""
    from repro_torch.sparql.parser import parse

    proj = parse(text).projection()
    d = store.dictionary
    return {tuple(d.lookup(r[v]) for v in proj) for r in rows}


def matrix_phase(dev, full: dict) -> dict:
    """Every full-scale query with every join on the matrix backend
    (join_backend="matrix", no size cap) on the card: rows equal in order
    to the mr backend's on the card (the matrix join promises mr_join's
    emission order) and, as sets, to the hash-join oracle; a warm repeat
    is 1 dispatch, 0 compiles and no host sync, and a stacked program of
    Q9 (match_layout on its sort-and-search path) runs with no host sync."""
    from repro_torch import kernels
    from repro_torch.sparql.engine import QueryEngine

    store, texts = full["store"], full["texts"]
    mr = QueryEngine(store, device=dev, join_backend="mr")
    mr_rows = {name: mr.query(text) for name, text in texts.items()}
    del mr
    engine = QueryEngine(store, device=dev, join_backend="matrix")
    torch.cuda.synchronize()
    clear_launches(kernels)  # the matrix path's launches start here
    report = {}
    for name, text in texts.items():
        pq = engine.prepare(text)
        t = time.perf_counter()
        cold = pq.run()
        cold_s = time.perf_counter() - t
        lat = []
        for _ in range(5):
            t = time.perf_counter()
            warm = pq.run()
            lat.append(time.perf_counter() - t)
        check(warm.stats.n_dispatches == 1 and warm.stats.n_compiles == 0,
              f"{name} [matrix] warm: {warm.stats}")
        backends = engine._canonicalize(pq._program)[1].join_backends
        check(all(b == "matrix" for b in backends),
              f"{name}: not every join on the matrix backend: {backends}")
        for run, res in (("cold", cold), ("warm", warm)):
            check(res.rows == mr_rows[name],
                  f"{name} [matrix] {run}: rows != the mr backend's rows "
                  "in order")
        check(id_rows(store, text, warm.rows) == full["oracle"][name],
              f"{name} [matrix]: rows != hash-join oracle")
        warm_without_sync(engine, pq)
        report[name] = {
            "rows": len(warm.rows), "backends": list(backends),
            "cold_s": cold_s, "warm_p50_ms": statistics.median(lat) * 1e3,
            "device_ms": warm.stats.device_time_s * 1e3,
            "join_totals": list(warm.stats.join_totals),
        }
        log(f"  matrix {name}: {report[name]}")
    launches = dict(kernels.LAUNCHES)
    device = dict(kernels.DEVICE_LAUNCHES)
    log(f"matrix backend: launches {launches}; device launches {device}")
    for k in ("match_layout", "sort_ranks"):
        check(launches.get(k, 0) > 0, f"kernel {k} was not launched [matrix]")
    for name, text in texts.items():  # after the count
        report[name]["match_layout_shapes"] = (
            kernel_shapes(engine.prepare(text))["match_layout"])
        log(f"  matrix {name} match_layout (lanes,) n_l, n_r, path: "
            f"{report[name]['match_layout_shapes']}")
    check(any(s[-1] == "sorted" for r in report.values()
              for s in r["match_layout_shapes"]),
          "no match_layout launch took the sort-and-search path")
    pqs = [engine.prepare(texts["Q9"]) for _ in range(2)]
    engine.run_batch(pqs)  # builds the width-2 program
    res = engine.run_batch(pqs)
    check(all(r.rows == mr_rows["Q9"] for r in res),
          "Q9 [matrix] stacked rows != the mr backend's rows")
    batch_without_sync(engine, pqs)
    return {"queries": report, "launches": launches,
            "device_launches": device}


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


# -- phase 8: the sharded engine -----------------------------------------------

SHARDS = 4
SHARDED_REPEATS = 10
# queries whose plan program alone is timed on both engines
PROFILED = ("Q1", "Q2", "Q9", "S1")


def sharded_queries(lubm) -> dict[str, str]:
    """Every LUBM query and the reference sharded program's F1 / O1 / FO1
    / U1 / DISTINCT / LIMIT shapes."""
    qs = {**lubm.QUERIES, **lubm.S_QUERIES, **lubm.OPERATOR_QUERIES}
    qs["D1q"] = lubm.PREFIX + "SELECT DISTINCT ?d WHERE { ?s ub:memberOf ?d . }"
    qs["L1"] = lubm.PREFIX + ("SELECT ?s ?d WHERE { ?s ub:memberOf ?d . } "
                              "LIMIT 17")
    return qs


def row_multiset(rows) -> list:
    return sorted(tuple(sorted(r.items())) for r in rows)


def warm_runs(pq, n: int):
    """`n` warm runs: (last result, wall p50 ms, device-part p50 ms), each
    run checked to be 1 dispatch and 0 compiles."""
    lat, dev_lat = [], []
    for _ in range(n):
        t = time.perf_counter()
        res = pq.run()
        lat.append(time.perf_counter() - t)
        dev_lat.append(res.stats.device_time_s)
        check(res.stats.n_dispatches == 1 and res.stats.n_compiles == 0,
              f"warm run: {res.stats}")
    return (res, statistics.median(lat) * 1e3,
            statistics.median(dev_lat) * 1e3)


def program_cost(engine, pq) -> dict:
    """One warm plan program of `pq` alone (scans staged, constants on the
    card): the card's busy time per call (the sum of its kernels' device
    times, from the profiler), its device launches and the kernels that
    take most of that time ((ms, launches) per call), and its host
    enqueue. Where the enqueue is the larger, the host sets the pace."""
    canon, shape, _ = engine._canonicalize(pq._program)
    consts = engine._device_consts(pq._program)
    program = engine.plan_cache.get(shape).compiled

    def call():
        return program(canon, *consts)

    kernels_run = device_breakdown(call, calls=3)
    if not isinstance(kernels_run, dict):
        return {"busy_ms": kernels_run, "enqueue_ms": enqueue_ms(call, 10)}
    return {
        "busy_ms": sum(ms for ms, _ in kernels_run.values()),
        "device_launches": sum(n for _, n in kernels_run.values()),
        "top_kernels": dict(sorted(
            kernels_run.items(), key=lambda kv: -kv[1][0])[:4]),
        "enqueue_ms": enqueue_ms(call, iters=10),
    }


def sharded_small_phase(dev) -> None:
    """LUBM scale 2 at 8 shards and on a 2 x 2 mesh, for correctness: the
    card's result arrays equal the CPU port's sharded engine's, and its
    rows, as multisets, the single-device card engine's."""
    from repro_torch.core.distributed import make_mesh
    from repro_torch.sparql import lubm
    from repro_torch.sparql.engine import QueryEngine, ShardedQueryEngine
    from repro_torch.sparql.parser import parse
    from repro_torch.sparql.sharded_store import shard_store

    base = lubm.generate(scale=SMALL_SCALE, join_shapes=True, skew_shapes=True)
    single = QueryEngine(base, device=dev)
    qs = {**all_queries(lubm), **sharded_queries(lubm)}
    for n, mesh in ((8, None), (4, make_mesh((2, 2), ("pod", "data")))):
        engines = {d: ShardedQueryEngine(shard_store(base, n), device=d,
                                         mesh=mesh) for d in (dev, "cpu")}
        for name, text in qs.items():
            q = parse(text)
            for run in ("cold", "warm"):
                (rc, sc), (rh, _) = (engines[d].execute(q)
                                     for d in (dev, "cpu"))
                check(torch.equal(rc.cols.cpu(), rh.cols)
                      and torch.equal(rc.valid.cpu(), rh.valid),
                      f"sharded {n} {name} {run}: cuda arrays != cpu arrays")
            check(sc.n_dispatches == 1 and sc.n_compiles == 0,
                  f"sharded {n} {name} warm: {sc}")
            got = row_multiset(engines[dev].query(text))
            want = row_multiset(single.query(text))
            if "LIMIT" in text:
                check(len(got) == len(want), f"sharded {n} {name}: length")
            else:
                check(got == want, f"sharded {n} {name}: rows != single")
        log(f"sharded small scale ({n} shards, mesh "
            f"{engines[dev].mesh.axis_sizes}): {len(qs)} queries, cuda == "
            "cpu, rows == the single-device engine's")


def sharded_phase(dev, full: dict) -> dict:
    """The full-scale store subject-hash sharded over SHARDS shards on the
    card: every query's rows equal the single-device card engine's (as
    multisets) and, where the hash-join oracle applies, the oracle's; a
    warm repeat is 1 dispatch, 0 compiles and no host sync; Q9's worst
    per-shard join bucket is below the single-device bucket; a program at
    the smallest buckets retries to the same rows; a stacked group and a
    short server burst over the sharded engine. Warm p50 and device part
    of both engines, in this call."""
    from repro_torch import kernels
    from repro_torch.serve.sparql_server import SPARQLServer
    from repro_torch.sparql import lubm
    from repro_torch.sparql.engine import (
        ExecStats, QueryEngine, ShardedQueryEngine,
    )
    from repro_torch.sparql.sharded_store import shard_store

    store = full["store"]
    qs = sharded_queries(lubm)
    t = time.perf_counter()
    sharded_store = shard_store(store, SHARDS)
    log(f"sharded: {SHARDS} shards of {sharded_store.shard_sizes()} triples "
        f"({time.perf_counter() - t:.1f} s, host)")
    single = QueryEngine(store, device=dev)
    engine = ShardedQueryEngine(sharded_store, device=dev)
    oracle = dict(full["oracle"])
    oracle["D1q"] = oracle_rows(store, qs["D1q"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clear_launches(kernels)  # the sharded path's launches start here
    report = {}
    for name, text in qs.items():
        spq = engine.prepare(text)
        t = time.perf_counter()
        cold = spq.run()
        cold_s = time.perf_counter() - t
        warm, p50, dev50 = warm_runs(spq, SHARDED_REPEATS)
        st = warm.stats
        report[name] = {
            "rows": len(warm.rows), "cold_s": cold_s,
            "warm_p50_ms": p50, "device_p50_ms": dev50,
            "shuffles_emitted": st.n_shuffles_emitted,
            "shuffles_elided": st.n_shuffles_elided,
            "broadcast_joins": st.n_broadcast_joins,
            "peak_join_bucket": st.peak_join_bucket,
            "join_totals": list(st.join_totals),
            "join_worst": list(st.join_worst),
            "shuffle_loads": list(st.shuffle_loads),
            "backends": list(spq._program.plan.join_backends),
            "rows_cold_equal_warm": row_multiset(cold.rows)
            == row_multiset(warm.rows),
        }
    # the local matrix join: every join of S1 and Q4 on the matrix backend
    matrix = ShardedQueryEngine(sharded_store, device=dev,
                                join_backend="matrix")
    matrix_rows = {}
    for name in ("S1", "Q4"):
        pq = matrix.prepare(qs[name])
        pq.run()
        matrix_rows[name] = warm_runs(pq, 2)[0].rows
    launches = dict(kernels.LAUNCHES)
    device = dict(kernels.DEVICE_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"sharded: peak device memory {peak} bytes; launches {launches}; "
        f"device launches {device}")
    for k in ("pair_expand", "match_layout", "sort_ranks"):
        check(launches.get(k, 0) > 0, f"kernel {k} was not launched [sharded]")
    for name, rows in matrix_rows.items():
        check(row_multiset(rows) == row_multiset(single.query(qs[name])),
              f"{name} [sharded, matrix]: rows != the single-device rows")

    # the single-device card engine, the same queries, after the count
    for name, text in qs.items():
        pq = single.prepare(text)
        pq.run()
        warm, p50, dev50 = warm_runs(pq, SHARDED_REPEATS)
        r = report[name]
        r.update(single_p50_ms=p50, single_device_p50_ms=dev50,
                 single_peak_join_bucket=warm.stats.peak_join_bucket)
        spq = engine.prepare(text)
        got = row_multiset(spq.run().rows)
        check(r["rows_cold_equal_warm"], f"{name} [sharded]: cold != warm")
        if "LIMIT" in text:
            full_rows = set(row_multiset(
                single.query(text.split("LIMIT")[0])))
            check(len(got) == len(warm.rows) and set(got) <= full_rows,
                  f"{name} [sharded]: not a right-sized slice")
        else:
            check(got == row_multiset(warm.rows),
                  f"{name} [sharded]: rows != the single-device rows")
        if name in oracle:
            check(id_rows(store, text, spq.run().rows) == oracle[name],
                  f"{name} [sharded]: rows != hash-join oracle")
        check(r["peak_join_bucket"] <= r["single_peak_join_bucket"],
              f"{name} [sharded]: per-shard bucket above the single one")
        warm_without_sync(engine, spq)
        if name in PROFILED:
            r["program"] = program_cost(engine, spq)
            r["single_program"] = program_cost(single, pq)
        log(f"  sharded {name}: {r}")
    check(report["Q9"]["peak_join_bucket"]
          < report["Q9"]["single_peak_join_bucket"],
          "Q9's worst per-shard join bucket is not below the single one")

    # the retry: a program at the smallest join and shuffle buckets
    retries = {}
    for name in ("Q2", "Q9"):
        pq = engine.prepare(qs[name])
        pq.run()
        shape = engine._batch_context(pq._program).shape
        entry = engine.plan_cache.get(shape)
        engine._compile_entry(
            shape, (8,) * len(entry.join_caps), ExecStats(),
            shuffle_caps=(8,) * len(entry.compiled.shuffle_caps),
        )
        res = pq.run()
        check(res.stats.n_retries >= 1, f"{name}: no retry at the "
              "smallest buckets")
        check(row_multiset(res.rows) == row_multiset(single.query(qs[name])),
              f"{name} [sharded retry]: rows != the single-device rows")
        grown = engine.plan_cache.get(shape).compiled.shuffle_caps
        retries[name] = {"retries": res.stats.n_retries,
                         "join_overflows": list(res.stats.join_overflows),
                         "shuffle_caps": list(grown)}
        log(f"  sharded retry {name}: {retries[name]}")
    check(any(c > 8 for r in retries.values() for c in r["shuffle_caps"]),
          "no shuffle bucket overflowed and grew in the retry runs")

    # run_batch of a same-shape group, and one stacked program with no sync
    variants = [qs["F1"].replace("prof_0_0_0", v) for v in
                ("prof_0_0_0", "prof_0_1_0", "prof_1_0_0", "nobody")]
    engine.run_batch([engine.prepare(v) for v in variants])
    out = engine.run_batch([engine.prepare(v) for v in variants])
    (group,) = engine.last_batch
    check(group.widths == (4,) and group.n_dispatches == 1
          and not group.fallback, f"sharded run_batch: {group}")
    for v, rs in zip(variants, out):
        check(row_multiset(rs.rows) == row_multiset(single.query(v)),
              "sharded run_batch rows != the single-device rows")
    batch_without_sync(engine, [engine.prepare(v) for v in variants])

    # a short server burst over the sharded engine
    srv = SPARQLServer(engine, max_batch=8, max_wait_s=0.02)
    burst_lat = {}
    try:
        for name in ("Q1", "Q4", "Q7"):
            want = row_multiset(single.query(qs[name]))
            got = engine.query(qs[name])
            check(row_multiset(got) == want, f"{name}: sharded rows")
            lat = burst(srv, qs[name], 8, got, got)
            burst_lat[name] = statistics.median(lat) * 1e3
        st = srv.stats()
    finally:
        srv.close()
    check(st["timeouts"] == 0 and st["batched"]["stacked_dispatches"] > 0,
          f"sharded serving: {st}")
    log(f"sharded serving burst p50 ms {burst_lat}; stacked dispatches "
        f"{st['batched']['stacked_dispatches']}")
    return {"shards": SHARDS, "queries": report, "launches": launches,
            "device_launches": device, "peak_bytes": peak,
            "retries": retries, "serving_p50_ms": burst_lat,
            "store": sharded_store}


# -- phase 9: the sharded engine across processes ------------------------------

RANKS = 4
RANK_REPEATS = 5
RANK_TIMEOUT_S = 240  # every process group's timeout: a hang fails in it
RANK_DIR = ROOT / "build" / "ranks"
# the queries whose id rows are held to the hash-join oracle on the ranks
ORACLE = ("Q1", "Q2", "Q4", "Q7", "Q9", "S1", "D1q")


def write_store(store, path: pathlib.Path) -> None:
    """The store's triples and terms, for the ranks to load (generating
    scale 1000 takes the host ~46 s; loading it a few)."""
    import numpy as np

    d = store.dictionary
    terms = "\0".join(d.decode(i) for i in range(len(d))).encode()
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, triples=store.triples,
             terms=np.frombuffer(terms, np.uint8))


def read_store(path: str, n_shards: int):
    """write_store's file as a store sharded over `n_shards`."""
    import numpy as np

    from repro_torch.sparql.dictionary import TermDict
    from repro_torch.sparql.sharded_store import ShardedTripleStore

    data = np.load(path)
    d = TermDict()
    d.encode_many(data["terms"].tobytes().decode().split("\0"))
    return ShardedTripleStore(data["triples"], d, n_shards)


def spawn_ranks(world: int, program: str, *args, device: str,
                backend: "str | None" = None, axis_sizes=None,
                axis_names=("shards",)) -> list:
    """Run `program(ranks, *args)` (a function of this file) on `world`
    spawned ranks with a file:// rendezvous under build/; returns each
    rank's result. Any rank's failure or hang fails the phase: the first
    rank to fail ends the others, and every rank is ended by the time
    limit."""
    import pickle
    import uuid

    import torch.multiprocessing as mp

    out = RANK_DIR / f"{program}-{uuid.uuid4().hex[:8]}"
    out.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(
        rank, world, str(out), program, args, device, backend, axis_sizes,
        axis_names)) for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 2 * RANK_TIMEOUT_S
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.2)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(30)
    errors = {r: (out / f"{r}.err").read_text()[-3000:]
              for r in range(world) if (out / f"{r}.err").exists()}
    codes = [p.exitcode for p in procs]
    check(codes == [0] * world and not errors,
          f"{program} on {world} ranks: exit codes {codes}; {errors}")
    return [pickle.loads((out / f"{r}.pkl").read_bytes())
            for r in range(world)]


def rank_main(rank, world, out, program, args, device, backend, axis_sizes,
              axis_names) -> None:
    """One spawned rank: join the group, run the program, leave."""
    import datetime
    import os
    import pickle
    import traceback

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        from repro_torch.core.ranks import init_ranks

        ranks = init_ranks(
            device=device, backend=backend, axis_sizes=axis_sizes,
            axis_names=axis_names, init_method=f"file://{out}/rendezvous",
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S),
        )
        try:
            result = globals()[program](ranks, *args)
        finally:
            ranks.close()
        with open(f"{out}/{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(f"{out}/{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


def stats_fields(st) -> dict:
    """The ExecStats fields every rank and the one-process engine share:
    all but the host clock and the decode's row count."""
    import dataclasses

    d = dataclasses.asdict(st)
    del d["device_time_s"], d["rows_emitted"]
    return d


def array_digest(rel) -> str:
    """sha1 of a result's arrays, in order."""
    import hashlib

    h = hashlib.sha1(rel.cols.cpu().numpy().tobytes())
    h.update(rel.valid.cpu().numpy().tobytes())
    return h.hexdigest()


def timed_execute(engine, text: str, repeats: int, calls=None) -> dict:
    """A query cold, then `repeats` warm runs of engine.execute (dispatch
    to the result arrays, no decode): the last run's array digest,
    ExecStats and id rows, the cold seconds, and with repeats the warm
    p50 and its device part (ms). `calls` gets each run's ExecStats as a
    follower records them."""
    from repro_torch.sparql.parser import parse

    q = parse(text)
    lat, dev_lat = [], []
    for i in range(1 + repeats):
        t = time.perf_counter()
        rel, st = engine.execute(q)
        lat.append(time.perf_counter() - t)
        dev_lat.append(st.device_time_s)
        if calls is not None:
            calls.append(("execute", [stats_fields(st)]))
    out = {"digest": array_digest(rel), "stats": stats_fields(st),
           "ids": rel.cols[rel.valid].cpu().numpy(),
           "rows": int(rel.valid.sum()), "cold_s": lat[0]}
    if repeats:
        out["warm_p50_ms"] = statistics.median(lat[1:]) * 1e3
        out["device_p50_ms"] = statistics.median(dev_lat[1:]) * 1e3
    return out


def reference_runs(engines: dict, script: dict) -> dict:
    """What the ranks are held to: the one-process engines' runs of the
    ranks' script, in this process."""
    from repro_torch.launch.serve import rows_digest

    ref = {"queries": {name: timed_execute(engines["mr"], text,
                                           RANK_REPEATS)
                       for name, text in script["queries"].items()}}
    eng = engines["mr"]
    eng.run_batch([eng.prepare(v) for v in script["batch"]])
    out = eng.run_batch([eng.prepare(v) for v in script["batch"]])
    ref["batch"] = [rows_digest(r.rows) for r in out]
    for kind in ("matrix", "retry"):
        for name in script[kind]:
            ref["queries"][f"{kind}/{name}"] = timed_execute(
                engines[kind], script["queries"][name], REPEATS_OF[kind])
    return ref


# warm repeats on the matrix and the retry engines: the retry is the cold
# run at the smallest buckets
REPEATS_OF = {"matrix": 1, "retry": 0}


def extra_engines(script: dict) -> list:
    """(kind, engine options) of the engines after the first that the
    script runs queries on."""
    kinds = [("matrix", {"join_backend": "matrix"}),
             ("retry", {"warmup_path": script["warmup"]})]
    return [(kind, kw) for kind, kw in kinds if script[kind]]


def lead_script(ranks, make_engine, script: dict) -> dict:
    """Rank 0: the script's calls, one engine after another, each closed
    so the followers move on with it."""
    from repro_torch.launch.serve import rows_digest

    rec = {"queries": {}, "calls": []}
    calls = rec["calls"]
    engine = make_engine()
    for name, text in script["queries"].items():
        rec["queries"][name] = timed_execute(engine, text, RANK_REPEATS,
                                             calls)
    for _ in range(2):
        out = engine.run_batch([engine.prepare(v) for v in script["batch"]])
        calls.append(("run_batch", [stats_fields(r.stats) for r in out]))
    rec["batch"] = [rows_digest(r.rows) for r in out]
    rec["batch_groups"] = [(g.widths, g.n_dispatches, g.fallback)
                           for g in engine.last_batch]
    engine.close()
    if script["no_sync"]:
        rec["no_sync"] = programs_without_sync(ranks, engine, script)
    for kind, kw in extra_engines(script):
        engine = make_engine(**kw)
        for name in script[kind]:
            rec["queries"][f"{kind}/{name}"] = timed_execute(
                engine, script["queries"][name], REPEATS_OF[kind], calls)
        engine.close()
    return rec


def follow_script(ranks, make_engine, script: dict) -> list:
    """A follower: each of lead_script's engines in turn, recording every
    call's ExecStats as rank 0 records its own."""
    calls = []

    def record(method, outcome):
        if isinstance(outcome, list):
            outcome = [repr(o) if isinstance(o, Exception)
                       else stats_fields(o) for o in outcome]
        calls.append((method, outcome))

    engine = make_engine()
    engine.follow(record)
    if script["no_sync"]:
        programs_without_sync(ranks, engine, script)
    for _, kw in extra_engines(script):
        make_engine(**kw).follow(record)
    return calls


def programs_without_sync(ranks, engine, script: dict) -> int:
    """Every rank calls each query's cached plan program with sync
    debugging set to "error" (warm_without_sync), in rank 0's order and
    plans, after the engine's lockstep ended: the collectives inside the
    program make no host sync."""
    from repro_torch.sparql.engine import PreparedQuery

    plans = ranks.broadcast(
        [(t, engine.prepare(t)._program) for t in script["queries"].values()]
        if ranks.rank == 0 else None)
    for text, prog in plans:
        warm_without_sync(
            engine, PreparedQuery(engine, text, prog.query, program=prog))
    return len(plans)


def scale_rank_prog(ranks, store_path: str, script: dict) -> dict:
    """The full script on one shard per rank: rank 0 leads, the others
    follow. Each rank's launches (counts set to 0 just before the engine
    runs), peak device memory and load time come back with it."""
    from repro_torch import kernels
    from repro_torch.sparql.engine import ShardedQueryEngine

    t = time.perf_counter()
    store = read_store(store_path, ranks.world_size)
    load_s = time.perf_counter() - t

    def make_engine(**kw):
        return ShardedQueryEngine(store, ranks=ranks, **kw)

    card = ranks.device.type == "cuda"
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    clear_launches(kernels)
    if ranks.rank == 0:
        rec = lead_script(ranks, make_engine, script)
    else:
        rec = {"calls": follow_script(ranks, make_engine, script)}
    if card:
        torch.cuda.synchronize()
    rec.update(rank=ranks.rank, backend=ranks.backend, load_s=load_s,
               device=str(ranks.device),
               launches=dict(kernels.LAUNCHES),
               device_launches=dict(getattr(kernels, "DEVICE_LAUNCHES", {})),
               peak_bytes=torch.cuda.max_memory_allocated() if card else None)
    return rec


def check_ranks(label: str, recs: list, ref: dict, oracle: dict,
                script: dict) -> dict:
    """Rank 0's arrays and ExecStats equal the one-process engine's, its
    id rows the oracle's, a warm run is 1 dispatch and 0 compiles; every
    follower's runs report rank 0's ExecStats, call for call; every rank
    launched the three kernels of the query path."""
    r0 = recs[0]
    for name, got in r0["queries"].items():
        want = ref["queries"][name]
        check(got["digest"] == want["digest"],
              f"{label} {name}: rank 0's arrays != the one-process engine's")
        check(got["stats"] == want["stats"],
              f"{label} {name}: ExecStats {got['stats']} != {want['stats']}")
        if name in oracle:
            ids = {tuple(int(x) for x in row) for row in got["ids"]}
            check(ids == oracle[name], f"{label} {name}: != oracle")
        if "/" not in name:
            check(got["stats"]["n_dispatches"] == 1
                  and got["stats"]["n_compiles"] == 0,
                  f"{label} {name}: warm {got['stats']}")
    for name in script["retry"]:
        check(r0["queries"][f"retry/{name}"]["stats"]["n_retries"] >= 1,
              f"{label} {name}: no retry at the smallest buckets")
    check(r0["batch"] == ref["batch"], f"{label}: run_batch rows")
    check(r0["batch_groups"] == [((4,), 1, False)],
          f"{label}: run_batch groups {r0['batch_groups']}")
    for rec in recs[1:]:
        check(rec["calls"] == r0["calls"], f"{label} rank {rec['rank']}: "
              "its runs' ExecStats != rank 0's")
    for rec in recs:
        for k in ("pair_expand", "match_layout", "sort_ranks"):
            check(rec["launches"].get(k, 0) > 0,
                  f"{label} rank {rec['rank']}: kernel {k} not launched")
    keep = ("rows", "cold_s", "warm_p50_ms", "device_p50_ms")
    return {
        "ranks": [{k: rec[k] for k in ("rank", "backend", "device",
                                       "load_s", "launches",
                                       "device_launches", "peak_bytes")}
                  for rec in recs],
        "queries": {name: {k: q[k] for k in keep if k in q}
                    for name, q in r0["queries"].items()},
        "one_process": {name: {k: q[k] for k in keep if k in q}
                        for name, q in ref["queries"].items()},
        "no_sync_programs": r0.get("no_sync"),
    }


def small_rank_prog(ranks, store_path: str, texts: dict) -> dict:
    """Each query cold and warm on a 2 x 2 mesh of ranks (rank 0 leads):
    rank 0's array digests and warm ExecStats."""
    from repro_torch.sparql.engine import ShardedQueryEngine

    engine = ShardedQueryEngine(read_store(store_path, ranks.world_size),
                                ranks=ranks)
    if ranks.rank != 0:
        return {"calls": engine.follow()}
    out = {name: {k: v for k, v in timed_execute(engine, text, 1).items()
                  if k in ("digest", "stats")}
           for name, text in texts.items()}
    engine.close()
    return out


def serve_burst(dev, shards: int, expected: dict) -> dict:
    """`serve --shards` under torch.distributed.run: `shards` ranks on
    `dev` over gloo at scale 2; every answer's row multiset equals the
    one-process engine's."""
    import os

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(shards), "-m", "repro_torch.launch.serve",
           "--mode", "sparql", "--shards", str(shards), "--device",
           str(dev), "--backend", "gloo", "--scale", str(SMALL_SCALE),
           "--n-queries", "4"]
    import repro_torch

    env = dict(os.environ)
    env["PYTHONPATH"] = str(pathlib.Path(repro_torch.__file__).parents[1])
    t = time.perf_counter()
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=2 * RANK_TIMEOUT_S)
    wall = time.perf_counter() - t
    check(out.returncode == 0,
          f"serve --shards {shards}: {out.stdout[-2000:]}{out.stderr[-3000:]}")
    got = {f"{q}#{i}": (int(n), digest) for q, i, n, digest in re.findall(
        r"^(Q\d)#(\d+): (\d+) rows, sha1 (\w+)$", out.stdout, re.MULTILINE)}
    check(len(got) == 4 * len(expected), f"serve answered {sorted(got)}")
    for key, answer in got.items():
        check(answer == expected[key.split("#")[0]],
              f"serve --shards {shards} {key}: {answer} != one process's "
              f"{expected[key.split('#')[0]]}")
    stats = re.search(r"^server stats: (.*)$", out.stdout, re.MULTILINE)
    return {"answers": len(got), "wall_s": wall,
            "server_stats": stats.group(1)[:400] if stats else None}


def ranks_phase(dev, full: dict, sharded: dict,
                nccl_only: bool = False) -> dict:
    """The sharded engine with one shard per process. On one card the
    ranks share cuda:0 over gloo (NCCL refuses two ranks on one card):
    its exchanges are staged through the host, so its times are not a
    measure of the card. NCCL runs at world = the card count; with
    `nccl_only`, that run and its references alone."""
    import json as _json

    from repro_torch.core.distributed import make_mesh
    from repro_torch.launch.serve import rows_digest
    from repro_torch.sparql import lubm
    from repro_torch.sparql.engine import ShardedQueryEngine
    from repro_torch.sparql.sharded_store import shard_store

    t0 = time.perf_counter()
    store, texts = full["store"], sharded_queries(lubm)
    path = RANK_DIR / "scale1000.npz"
    write_store(store, path)
    # the reference: phase 8's one-process configuration (its store, 4
    # shards on the card), in fresh engines that run the ranks' calls
    engines = {"mr": ShardedQueryEngine(sharded["store"], device=dev),
               "matrix": ShardedQueryEngine(sharded["store"], device=dev,
                                            join_backend="matrix")}
    variants = [texts["F1"].replace("prof_0_0_0", v) for v in
                ("prof_0_0_0", "prof_0_1_0", "prof_1_0_0", "nobody")]
    small = RANK_DIR / "small.json"
    script = {"queries": texts, "matrix": ("S1",), "retry": (),
              "batch": variants, "warmup": str(small), "no_sync": False}
    ref = reference_runs(engines, script)
    # a warmup file at the smallest buckets: every rank reads it, so every
    # rank retries alike (Q2 shuffles on every stage)
    engines["mr"].save_cache(str(small))
    data = _json.loads(small.read_text())
    for e in data["entries"]:
        e["join_caps"] = [8] * len(e["join_caps"])
        e["shuffle_caps"] = [8] * len(e["shuffle_caps"])
    small.write_text(_json.dumps(data))
    script["retry"] = ("Q2",)
    ref["queries"]["retry/Q2"] = timed_execute(ShardedQueryEngine(
        sharded["store"], device=dev, warmup_path=str(small)), texts["Q2"], 0)
    log(f"ranks: store written, references run "
        f"({time.perf_counter() - t0:.1f} s)")
    oracle = dict(full["oracle"])
    oracle["D1q"] = oracle_rows(store, texts["D1q"])
    out = {}
    if nccl_only:
        out["nccl"] = nccl_ranks(dev, path, script, ref, oracle, store, None)
        return out

    t = time.perf_counter()
    recs = spawn_ranks(RANKS, "scale_rank_prog", str(path), script,
                       device=str(dev), backend="gloo")
    out["gloo"] = check_ranks("gloo", recs, ref, oracle, script)
    out["gloo"]["wall_s"] = time.perf_counter() - t
    log(f"ranks, gloo, exchanges staged through the host ({RANKS} ranks on "
        f"{dev}, scale {FULL_SCALE}): every query's arrays and ExecStats "
        f"== the one-process engine's, rows == the oracle's; "
        f"{_json.dumps(out['gloo'])}")

    # a 2 x 2 mesh over 4 ranks at scale 2
    base = lubm.generate(scale=SMALL_SCALE, join_shapes=True, skew_shapes=True)
    small_path = RANK_DIR / "scale2.npz"
    write_store(base, small_path)
    mesh = ((2, 2), ("pod", "data"))
    one = ShardedQueryEngine(shard_store(base, 4), device=dev,
                             mesh=make_mesh(*mesh))
    want = {name: timed_execute(one, text, 1) for name, text in texts.items()}
    t = time.perf_counter()
    recs = spawn_ranks(4, "small_rank_prog", str(small_path), texts,
                       device=str(dev), backend="gloo", axis_sizes=mesh[0],
                       axis_names=mesh[1])
    for name in texts:
        for k in ("digest", "stats"):
            check(recs[0][name][k] == want[name][k],
                  f"2 x 2 ranks {name}: {k} != the one-process engine's")
    out["mesh_2x2"] = {"queries": len(texts),
                       "wall_s": time.perf_counter() - t}
    log(f"ranks, gloo, 2 x 2 mesh over 4 ranks at scale {SMALL_SCALE}: "
        f"{len(texts)} queries, arrays and ExecStats == the one-process "
        f"2 x 2 engine's")

    out["nccl"] = nccl_ranks(dev, path, script, ref, oracle, store,
                             (base, small_path))

    # a short burst through serve --shards on 4 ranks
    serve_store = lubm.generate(scale=SMALL_SCALE)
    one = ShardedQueryEngine(shard_store(serve_store, RANKS), device=dev)
    expected = {}
    for name, text in lubm.QUERIES.items():
        rows = one.query(text)
        expected[name] = (len(rows), rows_digest(rows))
    out["serve"] = serve_burst(dev, RANKS, expected)
    log(f"ranks, serve --shards {RANKS} under torch.distributed.run (gloo on "
        f"{dev}): {out['serve']}")
    out["wall_s"] = time.perf_counter() - t0
    return out


def nccl_ranks(dev, path, script: dict, ref: dict, oracle: dict, store,
               small) -> dict:
    """NCCL at world = the card count: on 4 cards the scale-1000 checks
    against `ref`, beside the single-device engine's warm p50 on `store`;
    on one card (NCCL's collectives on the path at world 1) the scale-2
    store of `small` (the store, its file) against a one-process engine
    over `world` shards. Every plan program is called with sync
    debugging set to "error"."""
    from repro_torch.sparql.engine import QueryEngine, ShardedQueryEngine
    from repro_torch.sparql.sharded_store import shard_store

    world = torch.cuda.device_count()
    t = time.perf_counter()
    if world == RANKS:
        nccl_script = dict(script, no_sync=True)
        recs = spawn_ranks(world, "scale_rank_prog", str(path), nccl_script,
                           device=None)
        out = check_ranks("nccl", recs, ref, oracle, nccl_script)
        single = QueryEngine(store, device=dev)
        out["single_device"] = {
            name: {k: v for k, v in timed_execute(
                single, text, RANK_REPEATS).items()
                if k in ("warm_p50_ms", "device_p50_ms")}
            for name, text in script["queries"].items()}
    else:
        check(small is not None, f"nccl at world {world}: no store for it")
        base, small_path = small
        one = ShardedQueryEngine(shard_store(base, world), device=dev)
        n_engines = {"mr": one, "matrix": ShardedQueryEngine(
            one.store, device=dev, join_backend="matrix")}
        nccl_script = dict(script, no_sync=True, retry=())
        n_ref = reference_runs(n_engines, nccl_script)
        recs = spawn_ranks(world, "scale_rank_prog", str(small_path),
                           nccl_script, device=None)
        out = check_ranks("nccl", recs, n_ref, {}, nccl_script)
    check(out["no_sync_programs"] == len(script["queries"]),
          "nccl: the no-sync check did not run every program")
    out["world"] = world
    out["wall_s"] = time.perf_counter() - t
    log(f"ranks, nccl at world {world}: arrays and ExecStats == the "
        f"one-process engine's, no host sync in any plan program; "
        f"{json.dumps(out)}")
    return out


def nccl_only(dev) -> dict:
    """The inputs phase 9's NCCL run needs without phases 2-8: the
    scale-1000 store, its oracle and its 4-shard partition."""
    from repro_torch.sparql import lubm
    from repro_torch.sparql.sharded_store import shard_store

    t = time.perf_counter()
    store = lubm.generate(scale=FULL_SCALE, join_shapes=True, skew_shapes=True)
    texts = sharded_queries(lubm)
    oracle = {name: oracle_rows(store, texts[name]) for name in ORACLE
              if name != "D1q"}
    log(f"nccl only: store and oracle ({time.perf_counter() - t:.1f} s)")
    return ranks_phase(dev, {"store": store, "oracle": oracle},
                       {"store": shard_store(store, SHARDS)}, nccl_only=True)


# -- phase 10: LM serving -----------------------------------------------------

# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet), at 700 W
BF16_FLOPS_PER_S = 989e12
LM_F32_TOL = dict(rtol=1e-4, atol=1e-4)  # float32 logits, card vs CPU
LM_BF16_ATOL = 5e-2  # bf16 logits of the reduced configs, card vs CPU
# bf16 logits of gemma3-1b at full depth, cached decode vs cacheless
# forward: the two round the residual stream to bf16 (eps 2^-8) apart at
# each of 26 layers, and the logits spread about +-5 (unit-RMS hidden
# against N(0, 1/d) embeddings), so a few ulps of the largest logits;
# a wrong position, mask or cache row moves logits by O(1)
LM_FULL_ATOL = 0.25
LM_PROMPT, LM_NEW, LM_MAX_LEN = 1024, 64, 1088
LM_CHECK_STEPS = (1, 16, 64)


def arch_config(arch: str, **changes):
    import dataclasses
    import importlib

    from repro_torch.configs.registry import ARCHS

    return dataclasses.replace(importlib.import_module(ARCHS[arch]).CONFIG,
                               **changes)


def param_bytes(params: dict) -> int:
    from repro_torch.models.transformer import _leaves

    return sum(a.numel() * a.element_size() for _, a in _leaves(params))


def generate_without_sync(gen, tokens, n_new: int):
    """The Generator's device loop with sync debugging at "error": any
    host sync inside prefill or decode raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = gen.generate_on_device(tokens, n_new)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out


def lm_reduced(dev) -> dict:
    """(a) The reduced config of every LM arch, float32 and bf16: the same
    seeded weights (drawn on the CPU) on the card and on the CPU port."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.registry import archs_of
    from repro_torch.launch.train import reduced_lm
    from repro_torch.models import transformer as T
    from repro_torch.serve.decode import Generator

    out = {}
    for arch in archs_of("lm"):
        vocab = 500 if arch == "granite-moe-3b-a800m" else 512
        base = reduced_lm(arch_config(arch), vocab=vocab)
        prompts = np.random.default_rng(len(arch)).integers(
            0, vocab, (2, 32)).astype(np.int32)
        tokens = torch.from_numpy(prompts)
        for dt in (torch.float32, torch.bfloat16):
            cfg = dataclasses.replace(base, dtype=dt)
            params = T.init_params(torch.Generator().manual_seed(0), cfg)
            card = Generator(cfg, params, device=dev, max_len=40)
            with torch.inference_mode():
                want = T.forward(params, tokens, cfg)[0]
                got = T.forward(card.params, tokens.to(dev), cfg)[0].cpu()
            name = f"{arch}/{str(dt).split('.')[-1]}"
            if dt == torch.float32:
                err = float_err(got, want, **LM_F32_TOL)
                toks = generate_without_sync(card, tokens.to(dev), 8).cpu()
                cpu = Generator(cfg, params, device="cpu", max_len=40)
                check(torch.equal(toks, torch.from_numpy(
                    cpu.generate(prompts, 8))),
                    f"{name}: greedy tokens differ between card and CPU")
            else:
                err = float_err(got, want, rtol=0.0, atol=LM_BF16_ATOL)
            out[name] = err
            log(f"lm {name}: logits max abs err {err:.3g} card vs CPU")
    return out


def top_two_gap(logits) -> torch.Tensor:
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def card_work(breakdown) -> tuple:
    """(launches, card busy ms) of one call, from `device_breakdown`."""
    if not isinstance(breakdown, dict):
        return breakdown, breakdown
    return (sum(n for _, n in breakdown.values()),
            round(sum(ms for ms, _ in breakdown.values()), 4))


def lm_full_width(dev) -> dict:
    """(b) gemma3-1b at full width and depth in bf16 on the card: 2 x 1024
    prompt tokens, 64 new; the main path (Generator) with no host sync;
    prefill and per-token decode times against their bounds; the cached
    decode's logits against a cacheless forward over the grown sequence."""
    import dataclasses

    from repro_torch.models import transformer as T
    from repro_torch.serve.decode import Generator

    cfg = arch_config("gemma3-1b")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_bytes = param_bytes(params)
    total, _ = T.count_params(cfg)
    check(total == 999_826_048, f"gemma3-1b has {total} parameters")
    tokens = torch.randint(0, cfg.vocab, (2, LM_PROMPT), dtype=torch.int32,
                           device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    gen = Generator(cfg, params, device=dev, max_len=LM_MAX_LEN)
    b = tokens.shape[0]

    # the main path, twice: the first call pays cuBLAS's set-up
    t = time.perf_counter()
    first = generate_without_sync(gen, tokens, LM_NEW).cpu()
    cold_s = time.perf_counter() - t
    t = time.perf_counter()
    again = generate_without_sync(gen, tokens, LM_NEW).cpu()
    warm_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()  # weights + serving
    check(first.shape == (b, LM_NEW) and bool((first >= 0).all())
          and bool((first < cfg.vocab).all()), "generated tokens out of range")
    log(f"lm gemma3-1b: generate {b} x {LM_PROMPT} + {LM_NEW}: cold "
        f"{cold_s:.3f} s, warm {warm_s:.3f} s; the two runs' tokens "
        f"{'equal' if torch.equal(first, again) else 'DIFFER'}")

    # timed and checked run: prefill, then 64 decode steps, each step's
    # logits kept at LM_CHECK_STEPS; CUDA events between the steps
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(LM_NEW + 2)]
    held = {}
    seq = [tokens]
    with torch.inference_mode():
        torch.cuda.synchronize()
        ev[0].record()
        nxt, kc, vc = gen.start(tokens)
        ev[1].record()
        for i in range(1, LM_NEW + 1):
            seq.append(nxt[:, None])
            logits = T.decode_logits(gen.params, kc, vc, LM_PROMPT + i - 1,
                                     nxt, cfg)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            ev[i + 1].record()
            if i in LM_CHECK_STEPS:
                held[i] = logits
        torch.cuda.synchronize()
        prefill_ms = ev[0].elapsed_time(ev[1])
        step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(1, LM_NEW + 1)]
        grown = torch.cat(seq, dim=1)
        check(torch.equal(grown[:, LM_PROMPT:].cpu(), first),
              "the timed decode's tokens differ from Generator.generate's")
        # cacheless: one KV chunk over the whole grown sequence (the chunk
        # rule refuses 1025-1088 tokens in 1024-token chunks)
        flat = dataclasses.replace(cfg, kv_chunk=LM_MAX_LEN)
        errs = {}
        for i, logits in held.items():
            full = T.forward(gen.params, grown[:, :LM_PROMPT + i], flat)[0]
            want = full[:, -1]
            errs[i] = float_err(logits, want, rtol=0.0, atol=LM_FULL_ATOL)
            same = float((logits.argmax(-1) == want.argmax(-1)).float().mean())
            log(f"lm gemma3-1b step {i}: cached vs cacheless logits max abs "
                f"err {errs[i]:.4f} (tol {LM_FULL_ATOL}), mean "
                f"{float((logits.float() - want.float()).abs().mean()):.5f}, "
                f"argmax agree {same:.2f}, |logit| max "
                f"{float(want[:, :cfg.vocab].float().abs().max()):.2f}")
            del full

    # the kernels of one decode step (at the last position) and of one
    # prefill: launches and card busy time a call
    def one_step():
        with torch.inference_mode():
            T.decode_logits(gen.params, kc, vc, LM_MAX_LEN - 1, nxt, cfg)

    def one_prefill():
        with torch.inference_mode():
            gen.start(tokens)

    breakdown = device_breakdown(one_step)
    launches, busy = card_work(breakdown)
    pre_launches, pre_busy = card_work(device_breakdown(one_prefill, calls=2))

    # bounds: prefill by its operations (2 N per token + causal attention)
    # over the bf16 peak; a decode step by its bytes (every weight once,
    # the cache rows written so far) over HBM
    kv_row = 2 * cfg.n_layers * b * cfg.n_kv_heads * cfg.d_head * 2
    prefill_flops = T.model_flops(cfg, "prefill", b, LM_PROMPT)
    prefill_bytes = n_bytes + kv_row * LM_PROMPT
    prefill_bound, prefill_by = max(
        (prefill_flops / BF16_FLOPS_PER_S * 1e3, "operations"),
        (prefill_bytes / HBM_BYTES_PER_S * 1e3, "bytes"))
    mid = LM_PROMPT + LM_NEW // 2
    decode_bytes = n_bytes + kv_row * mid
    decode_flops = T.model_flops(cfg, "decode", b, mid)
    decode_bound, decode_by = max(
        (decode_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
        (decode_flops / BF16_FLOPS_PER_S * 1e3, "operations"))
    p50 = statistics.median(step_ms)
    res = {
        "params": total, "param_bytes": n_bytes, "init_s": round(init_s, 3),
        "prefill_ms": round(prefill_ms, 4),
        "prefill_bound_ms": round(prefill_bound, 4),
        "prefill_bound_by": prefill_by,
        "decode_ms_p50": round(p50, 4),
        "decode_ms_min": round(min(step_ms), 4),
        "decode_ms_max": round(max(step_ms), 4),
        "decode_bound_ms": round(decode_bound, 4), "decode_bound_by": decode_by,
        "decode_tokens_per_s": round(b * 1e3 / p50, 2),
        "tokens_per_s": round(b * LM_NEW * 1e3 / (prefill_ms + sum(step_ms)), 2),
        "generate_warm_s": round(warm_s, 4), "generate_cold_s": round(cold_s, 4),
        "peak_bytes": peak, "step_launches": launches, "step_busy_ms": busy,
        "prefill_launches": pre_launches, "prefill_busy_ms": pre_busy,
        "step_top_kernels": sorted(breakdown.items(), key=lambda kv: -kv[1][0])[:6]
        if isinstance(breakdown, dict) else breakdown,
        "cached_vs_cacheless_err": errs,
    }
    idle = (f"card idle {1 - busy / p50:.2f} of a step"
            if isinstance(busy, float) else "card idle not measured")
    log(f"lm gemma3-1b full width: prefill {prefill_ms:.3f} ms (bound "
        f"{prefill_bound:.3f}, {res['prefill_bound_by']}); decode p50 "
        f"{p50:.3f} ms/token step (bound {decode_bound:.3f}, {decode_by}), "
        f"{res['decode_tokens_per_s']} tokens/s decode, "
        f"{res['tokens_per_s']} tokens/s overall; peak {peak} bytes; "
        f"{launches} launches and {busy} ms busy per decode step ({idle}); "
        f"{pre_launches} launches and {pre_busy} ms busy per prefill")
    del params, gen, kc, vc, held
    torch.cuda.empty_cache()
    return res


def lm_cut_depth(dev) -> dict:
    """(c) gemma3-1b at full width, 2 layers, float32: 2 x 64 prompts and 8
    new tokens on the card against the CPU port, same weights. Tokens
    equal; where a near-tie flips one, the CPU's top-two logit gap at
    that step is within the float32 tolerance."""
    import numpy as np

    from repro_torch.models import transformer as T
    from repro_torch.serve.decode import Generator

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: a float32 comparison would mean nothing")
    cfg = arch_config("gemma3-1b", n_layers=2, dtype=torch.float32)
    params = T.init_params(torch.Generator().manual_seed(2), cfg)
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32)
    card = Generator(cfg, params, device=dev, max_len=72)
    got = generate_without_sync(card, torch.from_numpy(prompts).to(dev), 8).cpu()
    # the CPU port, step by step, keeping each step's logits
    tokens = torch.from_numpy(prompts)
    with torch.inference_mode():
        want_logits = T.forward(params, tokens, cfg)[0]
        card_logits = T.forward(card.params, tokens.to(dev), cfg)[0].cpu()
        err = float_err(card_logits, want_logits, **LM_F32_TOL)
        cpu = Generator(cfg, params, device="cpu", max_len=72)
        nxt, kc, vc = cpu.start(tokens)
        steps = [want_logits[:, -1]]
        want = [nxt]
        for i in range(1, 8):
            logits = T.decode_logits(params, kc, vc, 64 + i - 1, nxt, cfg)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            steps.append(logits)
            want.append(nxt)
    want = torch.stack(want, dim=1)
    flips = []
    for row in range(want.shape[0]):
        diff = (got[row] != want[row]).nonzero()
        if len(diff):
            j = int(diff[0])
            gap = float(top_two_gap(steps[j][row]))
            flips.append((row, j, gap))
            check(gap <= 2 * LM_F32_TOL["atol"],
                  f"cut-depth gemma3-1b row {row} step {j}: tokens differ "
                  f"with a top-two gap of {gap}")
    log(f"lm gemma3-1b 2 layers float32: logits max abs err {err:.3g} card "
        f"vs CPU; tokens {'equal' if not flips else f'flipped at {flips}'}")
    return {"logits_err": err, "flips": flips}


def lm_phase(dev) -> dict:
    t0 = time.perf_counter()
    reduced = lm_reduced(dev)
    full = lm_full_width(dev)
    cut = lm_cut_depth(dev)
    secs = time.perf_counter() - t0
    log(f"phase 10 (LM serving): {secs:.1f} s")
    return {"reduced_err": reduced, "gemma3_1b": full, "gemma3_1b_2l_f32": cut,
            "seconds": round(secs, 1)}


# -- phase 11: GNN and recsys forward -----------------------------------------

# H100 SXM float32 peak outside the tensor cores (NVIDIA data sheet), at
# 700 W. Every matmul of these models runs in float32 with TF32 off; with
# a bfloat16 compute_dtype too, since the weights stay float32 and bf16
# activations against float32 weights compute in float32 (JAX's
# promotion, which the port keeps), so that bound uses this rate as well
F32_FLOPS_PER_S = 67e12
GNN_SMALL_TOL = dict(rtol=1e-4, atol=1e-4)  # the CPU tests' float32 bound
# published widths, card vs the CPU port: float32 dot products of up to
# 2,048 terms summed in another order (cuBLAS against the CPU's BLAS),
# through up to 18 residual blocks whose layer norms keep values O(1):
# ~1e-6 a block, a few 1e-5 at the output; a wrong edge, mask or weight
# moves outputs by O(0.1) or more
GNN_FULL_TOL = dict(rtol=1e-3, atol=1e-3)
# GraphCast's bf16 compute_dtype against float32 at minibatch_lg: node and
# edge activations rounded to bf16 (eps 2^-8) at each of 18 blocks; on the
# CPU port at 2,708-8,000 grid nodes the gap was 0.0036-0.0038 of the
# outputs' L2 norm and at most 0.027 (outputs' RMS 1.0, max 4.5)
GRAPHCAST_BF16_REL_L2 = 0.02
GRAPHCAST_BF16_ATOL = 0.1
GNN_REPEATS = 5
SEGMENT_KERNELS = ("chunk_sum_kernel", "finish_kernel")  # segment_sum.cu


def tree_to(tree, dev):
    """A nested dict / list of tensors, copied to `dev`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, dev) for v in tree]
    return tree.to(dev)


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def time_steps(fn, repeats: int) -> list[float]:
    """Device ms of each of `repeats` calls (CUDA events around each)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ms = []
    for _ in range(repeats):
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    return ms


def run_without_sync(fn, grad: bool = False):
    """One forward (or, with `grad`, one gradient or train step) with sync
    debugging at "error": any host sync inside raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with contextlib.nullcontext() if grad else torch.inference_mode():
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out


def segment_launches_per_forward(arch: str, cfg, g) -> int:
    """The sorted segment sums one forward makes: one per aggregation, and
    SchNet's per-graph readout."""
    from repro_torch.models.gnn.graphcast import _pick_chunks

    if arch == "gat-cora":
        return cfg.n_layers
    if arch == "schnet":
        return cfg.n_interactions + 1
    if arch == "meshgraphnet":
        return cfg.n_layers
    if not cfg.edge_stream_chunks:  # g2m, the processor, m2g
        return cfg.n_layers + 2
    return cfg.n_layers + sum(  # g2m and m2g, one per chunk
        _pick_chunks(e, cfg.edge_stream_chunks)
        for e in (g.n_edges, g.extras["m2g_src"].shape[0]))


def gnn_dims_of(g, cfg) -> dict:
    """_gnn_model_flops' dims from the batch itself (this run's sizes)."""
    dims = {"n": g.n_nodes, "e": g.n_edges}
    if "mesh_src" in g.extras:
        dims.update(n_mesh=g.extras["mesh_feat_init"].shape[0],
                    e_mesh=g.extras["mesh_src"].shape[0])
    return dims


class ModelPath:
    """Phases 11 and 12's runs of the main path: each counted for
    segment_reduce launches (set to 0 just before one forward, gradient or
    train step with sync debugging at "error", read just after), checked
    against the launches its aggregations need, then timed and profiled
    (those calls do not count)."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.launches = 0
        self.rows = {}

    def first(self, name: str, fn, want_launches: int, grad: bool = False):
        clear_launches(self.kernels)
        out = run_without_sync(fn, grad)
        got = self.kernels.LAUNCHES["segment_reduce"]
        clear_launches(self.kernels)
        check(got == want_launches,
              f"{name}: segment_reduce launched {got} times, its "
              f"aggregations need {want_launches}")
        self.launches += got
        return out

    def measure(self, name: str, fn, flops: float, n_bytes: int,
                launches: int, repeats: int = GNN_REPEATS,
                profile_calls: int = 3, **extra) -> dict:
        """Forward ms (CUDA events around each of `repeats` calls, p50)
        beside its bound, peak memory, and one call's device launches,
        card busy time and segment_reduce card time (profiler)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        def once():
            with torch.inference_mode():
                fn()

        ms = time_steps(once, repeats)
        peak = torch.cuda.max_memory_allocated()
        breakdown = device_breakdown(once, calls=profile_calls)
        clear_launches(self.kernels)
        n_launch, busy = card_work(breakdown)
        seg = ([v for k, v in breakdown.items()
                if k.startswith(SEGMENT_KERNELS)]
               if isinstance(breakdown, dict) else None)
        b_ms, b_by = max((flops / F32_FLOPS_PER_S * 1e3, "operations"),
                         (n_bytes / HBM_BYTES_PER_S * 1e3, "bytes"))
        p50 = statistics.median(ms)
        row = {
            "forward_ms_p50": round(p50, 4), "forward_ms_min": round(min(ms), 4),
            "forward_ms_max": round(max(ms), 4), "bound_ms": round(b_ms, 4),
            "bound_by": b_by, "flops": flops, "bytes": n_bytes,
            "peak_bytes": peak, "resident_bytes": base,
            "device_launches": n_launch, "busy_ms": busy,
            "segment_reduce_launches": launches,
            "segment_reduce_device_launches": (
                round(sum(n for _, n in seg), 2) if seg is not None
                else "not measured"),
            "segment_reduce_ms": (round(sum(t for t, _ in seg), 4)
                                  if seg is not None else "not measured"),
            "top_kernels": sorted(breakdown.items(),
                                  key=lambda kv: -kv[1][0])[:4]
            if isinstance(breakdown, dict) else breakdown,
            **extra,
        }
        idle = (f"card idle {1 - busy / p50:.2f}" if isinstance(busy, float)
                else "card idle not measured")
        log(f"gnn {name}: forward p50 {p50:.4f} ms (min {min(ms):.4f}, max "
            f"{max(ms):.4f}) against a bound of {b_ms:.4f} ms ({b_by}); peak "
            f"{peak} bytes ({base} resident); {n_launch} launches, "
            f"{busy} ms busy ({idle}); segment_reduce {launches} launches, "
            f"{row['segment_reduce_ms']} ms; {extra}")
        self.rows[name] = row
        return row


def gnn_small(dev, path: ModelPath) -> dict:
    """(a) Each GNN arch at its reduced config (GraphCast also streamed in
    4 chunks, SchNet also on a molecule batch) and DeepFM's small config,
    float32: the same seeded weights on the card and on the CPU port,
    outputs and losses within the tests' tolerance, every forward with
    no host sync."""
    from repro_torch.configs.registry import _gnn_module, archs_of
    from repro_torch.data.graphs import (
        make_full_graph, make_molecule_batch, to_device)
    from repro_torch.data.recsys import CTRPipeline
    from repro_torch.launch.train import reduced_gnn
    from repro_torch.models.recsys import deepfm as D

    def reduced(arch):
        return reduced_gnn(arch, arch_config(arch))

    d_feat = {"schnet": 1, "graphcast": 6, "gat-cora": 12, "meshgraphnet": 8}
    cases = [(arch, reduced(arch),
              make_full_graph(arch, 40, 90, 96, d_feat[arch], 3))
             for arch in archs_of("gnn")]
    cases.append(("graphcast", dataclasses.replace(
        reduced("graphcast"), edge_stream_chunks=4),
        make_full_graph("graphcast", 300, 2000, 2048, 6, 3, seed=5)))
    cases.append(("schnet", reduced("schnet"),
                  make_molecule_batch("schnet", 10, 24, 4, 1)))
    errs = {}
    for i, (arch, cfg, g_np) in enumerate(cases):
        mod = _gnn_module(arch)
        params = mod.init_params(torch.Generator().manual_seed(i), cfg)
        g_cpu, g_dev = to_device(g_np, "cpu"), to_device(g_np, dev)
        p_dev = tree_to(params, dev)
        name = f"{arch} reduced #{i}"
        got = path.first(name, lambda: mod.apply(p_dev, g_dev, cfg),
                         segment_launches_per_forward(arch, cfg, g_dev))
        loss = run_without_sync(lambda: mod.loss_fn(p_dev, g_dev, cfg))
        with torch.inference_mode():
            want = mod.apply(params, g_cpu, cfg)
            want_loss = mod.loss_fn(params, g_cpu, cfg)
        errs[name] = max(float_err(got.cpu(), want, **GNN_SMALL_TOL),
                         float_err(loss.cpu(), want_loss, **GNN_SMALL_TOL))
    cfg = D.DeepFMConfig(n_sparse=6, embed_dim=4, mlp_dims=(16, 16),
                         rows_per_field=50)
    params = D.init_params(torch.Generator().manual_seed(9), cfg)
    p_dev = tree_to(params, dev)
    ids = torch.from_numpy(CTRPipeline(6, 50, 32).batch_at(0)["ids"])
    ids_dev = ids.to(dev)
    cand = ids[:, :3] % 50
    cand_dev = cand.to(dev)
    got = path.first("deepfm reduced forward",
                     lambda: torch.sigmoid(D.forward(p_dev, ids_dev, cfg)), 2)
    scores = path.first("deepfm reduced retrieval",
                        lambda: D.retrieval_scores(p_dev, ids_dev[:1],
                                                   cand_dev, cfg), 2)
    with torch.inference_mode():
        errs["deepfm reduced"] = max(
            float_err(got.cpu(), torch.sigmoid(D.forward(params, ids, cfg)),
                      **GNN_SMALL_TOL),
            float_err(scores.cpu(), D.retrieval_scores(params, ids[:1], cand,
                                                       cfg), **GNN_SMALL_TOL))
    log(f"gnn reduced configs, card vs CPU port, max abs err: {errs}")
    return errs


def gnn_published(dev, path: ModelPath) -> dict:
    """(b) gat-cora on full_graph_sm, schnet on molecule, GraphCast at
    published width and depth on full_graph_sm's graph: card against the
    CPU port, float32, TF32 off, the same seeded weights; timed."""
    from repro_torch.configs.registry import (
        GNN_SHAPES, _gnn_cfg_for_shape, _gnn_dims, _gnn_model_flops,
        _gnn_module)
    from repro_torch.data.graphs import (
        make_full_graph, make_molecule_batch, to_device)

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: a float32 comparison would mean nothing")
    sm = GNN_SHAPES["full_graph_sm"]
    mol = GNN_SHAPES["molecule"]
    dims = _gnn_dims("gat-cora", sm, 1)
    runs = [
        ("gat-cora full_graph_sm", "gat-cora",
         make_full_graph("gat-cora", sm["n_nodes"], sm["n_edges"], dims["e"],
                         sm["d_feat"], sm["n_classes"])),
        ("schnet molecule", "schnet",
         make_molecule_batch("schnet", mol["n_nodes"], mol["n_edges"],
                             mol["batch"], mol["n_classes"])),
        ("graphcast full_graph_sm", "graphcast",
         make_full_graph("graphcast", sm["n_nodes"], sm["n_edges"],
                         dims["e"], arch_config("graphcast").n_vars,
                         sm["n_classes"])),
    ]
    out = {}
    for i, (name, arch, g_np) in enumerate(runs):
        mod = _gnn_module(arch)
        cfg = _gnn_cfg_for_shape(arch, arch_config(arch),
                                 _gnn_dims(arch, mol if arch == "schnet"
                                           else sm, 1))
        params = mod.init_params(torch.Generator().manual_seed(10 + i), cfg)
        g_cpu, g_dev = to_device(g_np, "cpu"), to_device(g_np, dev)
        p_dev = tree_to(params, dev)
        fn = lambda: mod.apply(p_dev, g_dev, cfg)  # noqa: E731
        n_seg = segment_launches_per_forward(arch, cfg, g_dev)
        got = path.first(name, fn, n_seg)
        with torch.inference_mode():
            want = mod.apply(params, g_cpu, cfg)
        err = float_err(got.cpu(), want, **GNN_FULL_TOL)
        flops = _gnn_model_flops(arch, cfg, gnn_dims_of(g_np, cfg)) / 3
        n_bytes = tree_bytes(p_dev) + tree_bytes(list(g_dev[:-1])) \
            + tree_bytes(g_dev.extras) + tree_bytes(got)
        out[name] = path.measure(name, fn, flops, n_bytes, n_seg,
                                 max_abs_err_vs_cpu=err)
        del params, p_dev, g_dev, g_cpu, got, want
    torch.cuda.empty_cache()
    return out


def distinct_row_bytes(flat_ids, width: int) -> int:
    """The float32 table bytes a lookup must read: each distinct row once."""
    return int(torch.unique(flat_ids).numel()) * width * 4


def deepfm_runs(dev, path: ModelPath) -> dict:
    """DeepFM at its published config (39 fields of 860,000 rows, embedding
    10, MLP 400-400-400), the weights drawn once on the CPU from a seed and
    copied to the card: (b) serve_p99 (sigmoid of forward, batch 512) and
    retrieval_cand (1,000,448 candidates, 3 item fields), card against
    the CPU port; (c) serve_bulk (batch 262,144), held to the CPU port on
    its first rows (a row's output depends only on that row)."""
    from repro_torch.configs.registry import RECSYS_SHAPES
    from repro_torch.data.recsys import CTRPipeline
    from repro_torch.models.recsys import deepfm as D

    cfg = arch_config("deepfm")
    t = time.perf_counter()
    params = D.init_params(torch.Generator().manual_seed(20), cfg)
    p_dev = tree_to(params, dev)
    torch.cuda.synchronize()
    log(f"deepfm: {cfg.total_rows} rows, {tree_bytes(params)} bytes of "
        f"weights drawn on the CPU and copied to the card in "
        f"{time.perf_counter() - t:.2f} s")
    mlp_flops = 2 * sum(a * b for a, b in zip(
        (cfg.n_sparse * cfg.embed_dim,) + cfg.mlp_dims, cfg.mlp_dims + (1,)))
    fm_flops = 4 * cfg.n_sparse * cfg.embed_dim
    out = {}
    for shape, prefix in (("serve_p99", None), ("serve_bulk", 4096)):
        b = RECSYS_SHAPES[shape]["batch"]
        ids = torch.from_numpy(
            CTRPipeline(cfg.n_sparse, cfg.rows_per_field, b).batch_at(0)["ids"])
        ids_dev = ids.to(dev)
        fn = lambda: torch.sigmoid(D.forward(p_dev, ids_dev, cfg))  # noqa: E731
        got = path.first(f"deepfm {shape}", fn, 2)
        rows = ids[:prefix] if prefix else ids
        with torch.inference_mode():
            want = torch.sigmoid(D.forward(params, rows, cfg))
        err = float_err(got[:prefix].cpu() if prefix else got.cpu(), want,
                        **GNN_SMALL_TOL)
        flat = (ids_dev + torch.arange(cfg.n_sparse, device=dev,
                                       dtype=torch.int32)
                * cfg.rows_per_field).reshape(-1)
        n_bytes = (distinct_row_bytes(flat, cfg.embed_dim + 1)
                   + tree_bytes(p_dev["mlp"]) + ids.numel() * 4 + b * 4)
        out[shape] = path.measure(
            f"deepfm {shape}", fn, b * (mlp_flops + fm_flops), n_bytes, 2,
            max_abs_err_vs_cpu=err,
            rows_held_to_cpu=prefix or b)
        del ids_dev, got, flat
    sh = RECSYS_SHAPES["retrieval_cand"]
    nc, f = sh["n_candidates"], cfg.n_item_fields
    user = torch.from_numpy(
        CTRPipeline(cfg.n_sparse, cfg.rows_per_field, 1).batch_at(1)["ids"])
    cand = torch.from_numpy(
        CTRPipeline(f, cfg.rows_per_field, nc).batch_at(2)["ids"])
    user_dev, cand_dev = user.to(dev), cand.to(dev)
    fn = lambda: D.retrieval_scores(p_dev, user_dev, cand_dev, cfg)  # noqa: E731
    got = path.first("deepfm retrieval_cand", fn, 2)
    with torch.inference_mode():
        want = D.retrieval_scores(params, user, cand, cfg)
    err = float_err(got.cpu(), want, **GNN_SMALL_TOL)
    flat = (cand_dev + torch.arange(f, device=dev, dtype=torch.int32)
            * cfg.rows_per_field).reshape(-1)
    n_bytes = (distinct_row_bytes(flat, cfg.embed_dim) + cand.numel() * 4
               + nc * 4 + cfg.n_sparse * (cfg.embed_dim + 1) * 4)
    out["retrieval_cand"] = path.measure(
        "deepfm retrieval_cand", fn, nc * (f + 1) * cfg.embed_dim * 2,
        n_bytes, 2, max_abs_err_vs_cpu=err)
    del params, p_dev
    torch.cuda.empty_cache()
    return out


def gnn_minibatch_lg(dev, path: ModelPath) -> dict:
    """(c) GraphCast at published width and depth at minibatch_lg's device
    dims (169,984 grid nodes, 168,960 edges; 42,496 mesh nodes, 297,472
    mesh edges), float32 and bf16 compute_dtype, and MeshGraphNet (15 x
    128) on a graph of the same dims, on the card: outputs finite, no host
    sync, GraphCast's bf16 run within a stated bound of its float32 run,
    MeshGraphNet against the CPU port."""
    from repro_torch.configs.registry import (
        GNN_SHAPES, _gnn_cfg_for_shape, _gnn_dims, _gnn_model_flops,
        _gnn_module)
    from repro_torch.data.graphs import make_full_graph, to_device

    sh = GNN_SHAPES["minibatch_lg"]
    out = {}
    dims = _gnn_dims("graphcast", sh, 1)
    cfg = arch_config("graphcast")
    t = time.perf_counter()
    g_np = make_full_graph("graphcast", dims["n"], dims["e"], dims["e"],
                           cfg.n_vars, sh["n_classes"])
    g_dev = to_device(g_np, dev)
    log(f"graphcast minibatch_lg graph: {g_np.n_nodes} grid nodes, "
        f"{g_np.n_edges} edges, {g_np.extras['mesh_feat_init'].shape[0]} "
        f"mesh nodes, {g_np.extras['mesh_src'].shape[0]} mesh edges, built "
        f"and copied in {time.perf_counter() - t:.2f} s")
    check(dims["n_mesh"] == g_np.extras["mesh_feat_init"].shape[0],
          "GraphCast mesh nodes differ from the registry's")
    mod = _gnn_module("graphcast")
    p_dev = mod.init_params(torch.Generator(device=dev).manual_seed(30), cfg)
    flops = _gnn_model_flops("graphcast", cfg, gnn_dims_of(g_np, cfg)) / 3
    n_seg = segment_launches_per_forward("graphcast", cfg, g_dev)
    res = {}
    for label, dt in (("float32", torch.float32), ("bf16", torch.bfloat16)):
        c = dataclasses.replace(cfg, compute_dtype=dt)
        fn = lambda c=c: mod.apply(p_dev, g_dev, c)  # noqa: E731
        name = f"graphcast minibatch_lg {label}"
        res[label] = path.first(name, fn, n_seg)
        check(res[label].shape == (dims["n"], cfg.n_vars)
              and bool(torch.isfinite(res[label]).all()),
              f"{name}: outputs not finite or of the wrong shape")
        n_bytes = tree_bytes(p_dev) + tree_bytes(list(g_dev[:-1])) \
            + tree_bytes(g_dev.extras) + tree_bytes(res[label])
        out[name] = path.measure(name, fn, flops, n_bytes, n_seg, repeats=3,
                                 profile_calls=2)
    diff = (res["bf16"] - res["float32"]).abs()
    rel = float(diff.norm() / res["float32"].norm())
    gap = float(diff.max())
    log(f"graphcast minibatch_lg: bf16 against float32: relative L2 {rel:.5f} "
        f"(bound {GRAPHCAST_BF16_REL_L2}), max abs {gap:.5f} (bound "
        f"{GRAPHCAST_BF16_ATOL}), float32 outputs' max "
        f"{float(res['float32'].abs().max()):.3f}")
    check(rel <= GRAPHCAST_BF16_REL_L2 and gap <= GRAPHCAST_BF16_ATOL,
          "graphcast minibatch_lg: bf16 run too far from float32")
    out["graphcast minibatch_lg bf16"].update(rel_l2_vs_float32=rel,
                                              max_abs_vs_float32=gap)
    del res, diff, p_dev, g_dev
    torch.cuda.empty_cache()

    cfg = _gnn_cfg_for_shape("meshgraphnet", arch_config("meshgraphnet"), dims)
    g_np = make_full_graph("meshgraphnet", dims["n"], dims["e"], dims["e"],
                           sh["d_feat"], sh["n_classes"])
    g_cpu, g_dev = to_device(g_np, "cpu"), to_device(g_np, dev)
    mod = _gnn_module("meshgraphnet")
    params = mod.init_params(torch.Generator().manual_seed(31), cfg)
    p_dev = tree_to(params, dev)
    fn = lambda: mod.apply(p_dev, g_dev, cfg)  # noqa: E731
    n_seg = segment_launches_per_forward("meshgraphnet", cfg, g_dev)
    name = "meshgraphnet minibatch_lg"
    got = path.first(name, fn, n_seg)
    check(bool(torch.isfinite(got).all()), f"{name}: outputs not finite")
    with torch.inference_mode():
        want = mod.apply(params, g_cpu, cfg)
    err = float_err(got.cpu(), want, **GNN_FULL_TOL)
    n_bytes = tree_bytes(p_dev) + tree_bytes(list(g_dev[:-1])) \
        + tree_bytes(g_dev.extras) + tree_bytes(got)
    out[name] = path.measure(
        name, fn, _gnn_model_flops("meshgraphnet", cfg,
                                   gnn_dims_of(g_np, cfg)) / 3,
        n_bytes, n_seg, max_abs_err_vs_cpu=err)
    del params, p_dev, g_dev, g_cpu, got, want
    torch.cuda.empty_cache()
    return out


def gnn_phase(dev) -> dict:
    from repro_torch import kernels

    t0 = time.perf_counter()
    path = ModelPath(kernels)
    small = gnn_small(dev, path)
    published = gnn_published(dev, path)
    deepfm = deepfm_runs(dev, path)
    large = gnn_minibatch_lg(dev, path)
    secs = time.perf_counter() - t0
    check(path.launches > 0, "segment_reduce was not launched by the models")
    log(f"phase 11 (GNN and recsys forward): {secs:.1f} s; segment_reduce "
        f"launched {path.launches} times by the model paths")
    return {"reduced_err": small, "runs": path.rows,
            "segment_reduce_launches": path.launches,
            "seconds": round(secs, 1)}


# -- phase 12: training --------------------------------------------------------

# card vs CPU port, one float32 train step: losses and grad norm within the
# LM tolerance; each updated leaf within 1e-5 (an AdamW update is about lr
# times the sign of m / sqrt(v): gradients that differ in their last bits
# move a param by a few ulps of lr at most; the steps held to it run with
# lr of 3e-5 or more, so a missing gradient shows); each gradient leaf
# within a relative L2 error of 1e-4 (the CPU tests' bound) of its own
# norm. A leaf whose exact gradient is zero (GAT's last a_dst when every
# score of a segment lies on one side of the leaky ReLU) carries float32
# rounding only: where the port's float64 gradient on the CPU puts a leaf
# at most GRAD_ZERO_REL of the whole, it is held to 1e-4 of 1e-4 of the
# whole gradient's norm instead
TRAIN_PARAM_ATOL = 1e-5
TRAIN_GRAD_REL_L2 = 1e-4
GRAD_ZERO_REL, GRAD_FLOOR_REL = 1e-9, 1e-4
GEMMA_TRAIN_BATCH, GEMMA_TRAIN_SEQ = 2, 4096  # train_4k's sequence, batch cut
GEMMA_TRAIN_STEPS, GEMMA_CKPT_EVERY = 6, 3
TRAIN_REPEATS = 3
# (name, rows, width, segments, dtype): the GraphCast processor's sum at
# minibatch_lg and DeepFM's one-row bags at train_batch (segments == rows)
AUTOGRAD_CASES = (
    ("graphcast processor f32", 297_472, 512, 42_496, torch.float32),
    ("graphcast processor bf16", 297_472, 512, 42_496, torch.bfloat16),
    ("deepfm train_batch bags", 65_536 * 39, 10, 65_536 * 39, torch.float32),
)


def check_close_trees(name: str, got, want, atol=None, rel=None,
                      exact=None) -> float:
    """Max over leaves of the abs error (atol) or the relative L2 error
    (rel, of the leaf's own norm, or of the floor where `exact`, the
    float64 gradient, is zero; see TRAIN_GRAD_REL_L2) of a card tree
    against a CPU tree; fails beyond the bound."""
    from repro_torch import tree as TT

    worst = 0.0
    total = sum(float(w.float().norm()) ** 2 for w in TT.leaves(want)) ** 0.5
    zero = [False] * len(TT.leaves(want))
    if exact is not None:
        total64 = sum(float(e.norm()) ** 2 for e in TT.leaves(exact)) ** 0.5
        zero = [float(e.norm()) <= GRAD_ZERO_REL * total64
                for e in TT.leaves(exact)]
    for path, g, w, z in zip(TT.paths(want), TT.leaves(got), TT.leaves(want),
                             zero):
        g = g.detach().cpu()
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{name} {path}: {g.dtype} {tuple(g.shape)} vs {w.dtype} "
              f"{tuple(w.shape)}")
        if rel is not None:
            scale = GRAD_FLOOR_REL * total if z else float(w.float().norm())
            err = float((g.float() - w.float()).norm()) / max(scale, 1e-30)
            check(err <= rel, f"{name} {path}: relative L2 {err} > {rel}")
        else:
            err = float((g.float() - w.float()).abs().max()) if w.numel() else 0.0
            check(err <= atol, f"{name} {path}: max abs err {err} > {atol}")
        worst = max(worst, err)
    return worst


def float64_grad(loss_fn, params, *args, cfg):
    """The port's gradient of `loss_fn(params, *args, cfg)` in float64 on
    the CPU (a config's `compute_dtype` too): which leaves are exactly
    zero."""
    from repro_torch import tree as TT

    def up(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            return x.double() if x.is_floating_point() else x
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(up(v) for v in x))
        if isinstance(x, dict):
            return {k: up(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(up(v) for v in x)
        return x

    if hasattr(cfg, "compute_dtype"):
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float64)
    return TT.grad(loss_fn, up(params), *up(list(args)), cfg, has_aux=False)


def check_finite_metrics(name: str, metrics: dict) -> dict:
    from repro_torch.train.trainer import host_metrics

    vals = host_metrics(metrics)
    check(all(v == v and abs(v) != float("inf") for v in vals.values()),
          f"{name}: a metric is not finite: {vals}")
    return vals


def kernel_autograd(dev) -> dict:
    """Row 5 with a gradient at the GraphCast processor's shape (f32, bf16)
    and at DeepFM's train_batch bags, with dropped ids: the forward bit-equal
    to the kernel's without a gradient, the backward equal to the plain
    version's backward (a gather: exact)."""
    from repro_torch.kernels.segment_reduce import ops, ref

    gen = torch.Generator(device=dev).manual_seed(40)
    out = {}
    for name, n, d, s, dt in AUTOGRAD_CASES:
        if s == n:  # one-row bags, ids 0..n-1, a few dropped at each end
            ids = torch.arange(n, dtype=torch.int32, device=dev) - 3
        else:
            ids = torch.sort(torch.randint(-2, s + 2, (n,), generator=gen,
                                           device=dev, dtype=torch.int32)).values
        data = torch.randn((n, d), generator=gen, device=dev).to(dt)
        g = torch.randn((s, d), generator=gen, device=dev).to(dt)
        with torch.no_grad():
            plain_fwd = ops.sorted_segment_sum(data, ids, s)
        x = data.clone().requires_grad_(True)
        y = data.clone().requires_grad_(True)
        got = ops.sorted_segment_sum(x, ids, s)
        check(got.requires_grad and torch.equal(got, plain_fwd),
              f"{name}: the forward with a gradient differs from the kernel's")
        got.backward(g)
        ref.sorted_segment_sum(y, ids, s).backward(g)
        torch.cuda.synchronize()
        check(x.grad.dtype == dt and torch.equal(x.grad, y.grad),
              f"{name}: the backward differs from the plain version's")
        dropped = int(((ids < 0) | (ids >= s)).sum())
        check(dropped > 0 and not bool(x.grad[(ids < 0) | (ids >= s)].any()),
              f"{name}: dropped ids got a gradient")
        out[name] = {"rows": n, "width": d, "segments": s, "dropped": dropped,
                     "forward_bit_equal": True, "backward_equal": True}
        del data, x, y, got, g, plain_fwd
    torch.cuda.empty_cache()
    log(f"train kernel autograd: forward bit-equal, backward equal: {out}")
    return out


def lm_train_reduced(dev) -> dict:
    """One float32 train step of each reduced LM arch (and two
    micro-batches), card against the CPU port, the same seeded weights."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.registry import archs_of
    from repro_torch.launch.train import reduced_lm
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: a float32 comparison would mean nothing")
    out = {}
    for arch in archs_of("lm"):
        vocab = 500 if arch == "granite-moe-3b-a800m" else 512
        cfg = dataclasses.replace(reduced_lm(arch_config(arch), vocab=vocab),
                                  dtype=torch.float32)
        params = T.init_params(torch.Generator().manual_seed(5), cfg)
        toks = torch.from_numpy(np.random.default_rng(len(arch)).integers(
            0, vocab, (4, 65)).astype(np.int32))
        batch = {"tokens": toks[:, :-1].contiguous(),
                 "labels": toks[:, 1:].contiguous()}
        for n_micro in (1, 2):
            step = T.make_train_step(cfg, AdamWConfig(warmup_steps=10),
                                     n_micro)
            p_dev = tree_to(params, dev)
            p1, s1, m1 = step(p_dev, adamw_init(p_dev),
                              {k: v.to(dev) for k, v in batch.items()})
            p0, s0, m0 = step(params, adamw_init(params), batch)
            name = f"{arch} n_micro={n_micro}"
            got = check_finite_metrics(name, m1)
            want = {k: float(v) for k, v in m0.items()}
            for k in ("loss", "aux", "grad_norm"):
                check(abs(got[k] - want[k]) <= 1e-4 + 1e-4 * abs(want[k]),
                      f"{name}: {k} {got[k]} on the card, {want[k]} on the CPU")
            err = check_close_trees(name, p1, p0, atol=TRAIN_PARAM_ATOL)
            err = max(err, check_close_trees(name, s1["m"], s0["m"],
                                             atol=TRAIN_PARAM_ATOL))
            out[name] = {"loss": got["loss"], "param_max_abs_err": err}
    log(f"train lm reduced, card vs CPU (loss, max abs err): {out}")
    return out


def checkpoint_root() -> pathlib.Path:
    """build/ under the checkout (gitignored): temporary checkpoint
    directories go there and are removed when their run ends."""
    d = ROOT / "build"
    d.mkdir(exist_ok=True)
    return d


def lm_train_launcher(dev) -> dict:
    """30 steps of `python -m repro_torch.launch.train --arch olmoe-1b-7b`
    on the card (its main, in this process): the mean loss of the last 10
    steps below the first 10's, as examples/train_lm.py asserts."""
    import tempfile

    from repro_torch.launch import train

    with tempfile.TemporaryDirectory(dir=checkpoint_root()) as d:
        t = time.perf_counter()
        hist = train.main(["--arch", "olmoe-1b-7b", "--steps", "30",
                           "--ckpt-dir", d, "--ckpt-every", "10",
                           "--device", str(dev)])
        secs = time.perf_counter() - t
    check(len(hist) == 30 and not any("skipped" in h for h in hist),
          "the launcher skipped a step or stopped early")
    first = sum(h["loss"] for h in hist[:10]) / 10
    last = sum(h["loss"] for h in hist[-10:]) / 10
    check(last < first, f"the launcher's loss did not fall: first 10 "
          f"{first:.4f}, last 10 {last:.4f}")
    log(f"train launcher olmoe-1b-7b (reduced), 30 steps on the card in "
        f"{secs:.1f} s: mean loss first 10 {first:.4f}, last 10 {last:.4f}")
    return {"loss_first10": first, "loss_last10": last,
            "seconds": round(secs, 2),
            "step_ms_p50": round(statistics.median(h["dt"] for h in hist[1:])
                                 * 1e3, 3)}


def lm_train_restart(dev) -> dict:
    """A crash after step 6 and a restart from step 4's checkpoint
    (run_with_restarts) against the uninterrupted run, on the card: the
    params and AdamW state bit for bit."""
    import dataclasses
    import tempfile

    from repro_torch import tree as TT
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.train import reduced_lm
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import (Trainer, TrainSettings,
                                           run_with_restarts)

    cfg = dataclasses.replace(reduced_lm(arch_config("olmoe-1b-7b")),
                              dtype=torch.float32)

    def make(path, fail_at=-1):
        params = T.init_params(torch.Generator(device=dev).manual_seed(6), cfg)
        return Trainer(
            T.make_train_step(cfg, AdamWConfig(lr=1e-3)), params,
            TokenPipeline(vocab=cfg.vocab, batch=4, seq=32), str(path),
            TrainSettings(total_steps=10, ckpt_every=4, log_every=0,
                          fail_at_step=fail_at, skip_nonfinite_steps=False),
            to_device=lambda b: {k: torch.from_numpy(v).to(dev)
                                 for k, v in b.items()})

    with tempfile.TemporaryDirectory(dir=checkpoint_root()) as d:
        d = pathlib.Path(d)
        straight = make(d / "a")
        straight.run()
        calls = []

        def factory():
            calls.append(1)
            return make(d / "b", fail_at=6 if len(calls) == 1 else -1)

        resumed = run_with_restarts(factory)
    check(len(calls) == 2 and resumed.step == straight.step == 10,
          "the restart did not resume and finish")
    same = all(torch.equal(a, b) for a, b in zip(
        TT.leaves({"p": resumed.params, "s": resumed.opt_state}),
        TT.leaves({"p": straight.params, "s": straight.opt_state})))
    check(same, "the restarted run differs from the uninterrupted run")
    log("train restart on the card: crash after step 6, resumed from step 4, "
        "params and AdamW state bit-equal to the uninterrupted run")
    return {"restarts": len(calls) - 1, "bit_equal": same}


def lm_train_cut_depth(dev) -> dict:
    """gemma3-1b at full width with 2 layers, float32, one train step of
    2 x 64 tokens: card against the CPU port."""
    import numpy as np

    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    cfg = arch_config("gemma3-1b", n_layers=2, dtype=torch.float32)
    params = T.init_params(torch.Generator().manual_seed(7), cfg)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab, (2, 65)).astype(np.int32))
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    step = T.make_train_step(cfg, AdamWConfig(warmup_steps=10))
    p_dev = tree_to(params, dev)
    p1, _, m1 = step(p_dev, adamw_init(p_dev),
                     {k: v.to(dev) for k, v in batch.items()})
    p1 = tree_to(p1, "cpu")
    del p_dev
    torch.cuda.empty_cache()
    t = time.perf_counter()
    p0, _, m0 = step(params, adamw_init(params), batch)
    cpu_s = time.perf_counter() - t
    got = check_finite_metrics("gemma3-1b 2 layers", m1)
    for k in ("loss", "grad_norm"):
        check(abs(got[k] - float(m0[k])) <= 1e-4 + 1e-4 * abs(float(m0[k])),
              f"gemma3-1b 2 layers: {k} {got[k]} on the card, "
              f"{float(m0[k])} on the CPU")
    err = check_close_trees("gemma3-1b 2 layers", p1, p0, atol=TRAIN_PARAM_ATOL)
    log(f"train gemma3-1b 2 layers float32: loss {got['loss']:.5f} (CPU "
        f"{float(m0['loss']):.5f}), params max abs err {err:.3g} card vs CPU "
        f"(the CPU step {cpu_s:.1f} s)")
    return {"loss": got["loss"], "param_max_abs_err": err}


def train_row(name: str, step_ms: list, flops_by_rate: list, n_bytes: int,
              breakdown, peak: int, opt_ms: list, items: int, unit: str,
              **extra) -> dict:
    """One training config's numbers: step ms (p50) beside its bound (the
    larger of the operations, summed over (flops, rate) pairs, and the
    bytes over HBM), items a second, peak memory, launches and card busy
    ms a step, and the optimizer's ms apart."""
    ops_ms = sum(f / r for f, r in flops_by_rate) * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    b_ms, b_by = max((ops_ms, "operations"), (bytes_ms, "bytes"))
    p50 = statistics.median(step_ms)
    launches, busy = card_work(breakdown)
    row = {"step_ms_p50": round(p50, 4), "step_ms_min": round(min(step_ms), 4),
           "step_ms_max": round(max(step_ms), 4), "bound_ms": round(b_ms, 4),
           "bound_by": b_by, f"{unit}_per_s": round(items * 1e3 / p50, 2),
           "peak_bytes": peak, "device_launches": launches, "busy_ms": busy,
           "optimizer_ms": round(statistics.median(opt_ms), 4), **extra}
    if isinstance(breakdown, dict):
        row["top_kernels"] = sorted(breakdown.items(),
                                    key=lambda kv: -kv[1][0])[:5]
    idle = (f"card idle {1 - busy / p50:.2f}" if isinstance(busy, float)
            else "card idle not measured")
    log(f"train {name}: step p50 {p50:.3f} ms (min {min(step_ms):.3f}, max "
        f"{max(step_ms):.3f}) against a bound of {b_ms:.3f} ms ({b_by}); "
        f"{row[f'{unit}_per_s']} {unit}/s; peak {peak} bytes; {launches} "
        f"launches, {busy} ms busy a step ({idle}); optimizer "
        f"{row['optimizer_ms']} ms; {extra}")
    return row


def optimizer_ms(grads, state, params, opt_cfg) -> list[float]:
    from repro_torch.optim.adamw import adamw_update

    return time_steps(lambda: adamw_update(opt_cfg, grads, state, params),
                      TRAIN_REPEATS)


def lm_train_full_width(dev) -> dict:
    """gemma3-1b at full width and depth in bf16, remat on, AdamW
    DEFAULT_OPT, batch 2 x 4096: 6 Trainer steps with an async checkpoint
    every 3 (the host snapshot before save returns), every step finite,
    the last checkpoint restored bit for bit; step ms beside its bound,
    tokens/s, peak memory, launches and busy ms, the optimizer apart."""
    import tempfile

    from repro_torch import tree as TT
    from repro_torch.configs.registry import DEFAULT_OPT
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.trainer import Trainer, TrainSettings

    cfg = arch_config("gemma3-1b")
    check(cfg.remat and cfg.dtype == torch.bfloat16, "gemma3-1b: remat, bf16")
    b, s = GEMMA_TRAIN_BATCH, GEMMA_TRAIN_SEQ
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    n_params, _ = T.count_params(cfg)
    step_fn = T.make_train_step(cfg, DEFAULT_OPT)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=b, seq=s)
    writes, snapshots = [], []
    with tempfile.TemporaryDirectory(dir=checkpoint_root()) as d:
        tr = Trainer(step_fn, params, pipe, d, TrainSettings(
            total_steps=GEMMA_TRAIN_STEPS, ckpt_every=GEMMA_CKPT_EVERY,
            log_every=0, keep_k=1, async_ckpt=True,
            skip_nonfinite_steps=False),
            to_device=lambda bt: {k: torch.from_numpy(v).to(dev)
                                  for k, v in bt.items()})
        write, save = tr.mgr._write, tr.mgr.save

        def timed_write(*a):
            t = time.perf_counter()
            write(*a)
            writes.append(time.perf_counter() - t)

        def timed_save(*a, **k):
            tr.mgr.wait()  # the previous write, apart from the snapshot
            t = time.perf_counter()
            save(*a, **k)  # returns after the host snapshot
            snapshots.append((time.perf_counter() - t) * 1e3)

        tr.mgr._write, tr.mgr.save = timed_write, timed_save
        del params
        t = time.perf_counter()
        hist = tr.run()  # waits for the last write
        run_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        check(len(hist) == GEMMA_TRAIN_STEPS and all(
            all(v == v and abs(v) != float("inf") for v in h.values())
            for h in hist), "gemma3-1b: a train step was not finite")
        check(tr.mgr.all_steps() == [GEMMA_TRAIN_STEPS],
              f"gemma3-1b: checkpoints {tr.mgr.all_steps()}")
        ckpt_bytes = sum(f.stat().st_size for f in pathlib.Path(d).rglob("*")
                         if f.is_file())
        torch.cuda.empty_cache()
        t = time.perf_counter()
        back = tr.mgr.restore(GEMMA_TRAIN_STEPS,
                              {"params": tr.params, "opt": tr.opt_state})
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        same = all(torch.equal(x, y) for x, y in zip(
            TT.leaves(back), TT.leaves({"params": tr.params,
                                        "opt": tr.opt_state})))
        check(same, "gemma3-1b: the restored checkpoint differs")
        check(tr.mgr.meta(GEMMA_TRAIN_STEPS)["pipeline"]["step"]
              == GEMMA_TRAIN_STEPS, "gemma3-1b: pipeline state not saved")
        del back
    torch.cuda.empty_cache()
    log(f"train gemma3-1b full width: {GEMMA_TRAIN_STEPS} Trainer steps in "
        f"{run_s:.1f} s, losses {[round(h['loss'], 4) for h in hist]}; "
        f"checkpoint {ckpt_bytes} bytes: host snapshot ms {snapshots}, "
        f"write s {[round(w, 2) for w in writes]}, restore {restore_s:.2f} s, "
        f"bit-equal")

    # timed steps on one batch, then the gradient alone, then the optimizer
    batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(0).items()}
    params, state = tr.params, tr.opt_state
    del tr
    torch.cuda.reset_peak_memory_stats()
    ms = time_steps(lambda: step_fn(params, state, batch), TRAIN_REPEATS)
    step_peak = torch.cuda.max_memory_allocated()
    breakdown = device_breakdown(lambda: step_fn(params, state, batch), calls=1)
    grads, _ = TT.grad(T.make_loss_fn(cfg), params, batch["tokens"],
                       batch["labels"])
    opt = optimizer_ms(grads, state, params, DEFAULT_OPT)
    del grads
    # bound: 6 N per token in bf16 GEMMs, plus the float32 attention the
    # function needs: 4 B H Dh flops (scores and values) for each pair of
    # a query and a key it may see, causal on global layers and within the
    # window on local ones, run 4 times (forward, the remat recompute, the
    # backward's two). Beside it, the attention as the port computes it
    # (every KV chunk of every layer, masked pairs included: S^2 a layer)
    # and the reference's model_flops, which counts one layer's causal
    # attention
    tokens = b * s
    gemm = 6.0 * n_params * tokens
    w = min(cfg.sliding_window or s, s)
    pairs = sum(s * (s + 1) // 2 if is_global
                else w * (w + 1) // 2 + (s - w) * w
                for is_global in cfg.is_global_layers())
    per_pair = 4.0 * b * cfg.n_heads * cfg.d_head * 4
    attn = per_pair * pairs
    attn_computed = per_pair * s * s * cfg.n_layers
    row = train_row(
        "gemma3-1b full width", ms,
        [(gemm, BF16_FLOPS_PER_S), (attn, F32_FLOPS_PER_S)],
        30 * n_params, breakdown, max(peak, step_peak), opt, tokens, "tokens",
        batch=b, seq=s, params=n_params, trainer_peak_bytes=peak,
        losses=[h["loss"] for h in hist],
        trainer_step_s=[round(h["dt"], 4) for h in hist],
        model_flops_bound_ms=round(
            T.model_flops(cfg, "train", b, s) / BF16_FLOPS_PER_S * 1e3, 4),
        gemm_bound_ms=round(gemm / BF16_FLOPS_PER_S * 1e3, 4),
        attention_bound_ms=round(attn / F32_FLOPS_PER_S * 1e3, 4),
        attention_as_computed_ms=round(attn_computed / F32_FLOPS_PER_S * 1e3, 4),
        bound_as_computed_ms=round((gemm / BF16_FLOPS_PER_S + attn_computed
                                    / F32_FLOPS_PER_S) * 1e3, 4),
        checkpoint_bytes=ckpt_bytes, checkpoint_snapshot_ms=snapshots,
        checkpoint_write_s=writes, checkpoint_restore_s=round(restore_s, 3),
        checkpoint_bit_equal=same, trainer_run_s=round(run_s, 2))
    del params, state, batch
    torch.cuda.empty_cache()
    return row


def train_step_launches(arch: str, cfg, g) -> int:
    """The sorted segment sums one train step makes: the forward's
    (`segment_launches_per_forward`), and again every rematerialized
    block's in the backward (all of GraphCast's and MeshGraphNet's
    aggregations lie in blocks); the backward of a sum is a gather."""
    fwd = segment_launches_per_forward(arch, cfg, g)
    return fwd * (2 if getattr(cfg, "remat", False) else 1)


def gnn_train_small(dev, path: ModelPath) -> dict:
    """Each GNN arch at its reduced config (MeshGraphNet and GraphCast also
    with remat, GraphCast also streamed) and DeepFM's small config, float32:
    every gradient leaf card against the CPU port (relative L2 1e-4: the
    params upstream of an aggregation get theirs through the kernel's
    backward), then one registry train step with a warmup of 2 (lr 1.5e-4,
    so that an update is well above the params' 1e-5)."""
    from repro_torch import tree as TT
    from repro_torch.configs.registry import (
        DEFAULT_OPT, _gnn_module, archs_of, deepfm_train_step, gnn_train_step)
    from repro_torch.data.graphs import make_full_graph, to_device
    from repro_torch.data.recsys import CTRPipeline
    from repro_torch.launch.train import reduced_gnn
    from repro_torch.models.recsys import deepfm as D
    from repro_torch.optim.adamw import adamw_init

    def reduced(arch, **changes):
        return dataclasses.replace(reduced_gnn(arch, arch_config(arch)),
                                   **changes)

    opt = dataclasses.replace(DEFAULT_OPT, warmup_steps=2)

    d_feat = {"schnet": 1, "graphcast": 6, "gat-cora": 12, "meshgraphnet": 8}
    cases = [(arch, reduced(arch),
              make_full_graph(arch, 40, 90, 96, d_feat[arch], 3))
             for arch in archs_of("gnn")]
    cases += [("meshgraphnet", reduced("meshgraphnet", remat=True),
               make_full_graph("meshgraphnet", 40, 90, 96, 8, 3)),
              ("graphcast", reduced("graphcast", remat=True,
                                    edge_stream_chunks=4),
               make_full_graph("graphcast", 300, 2000, 2048, 6, 3, seed=5))]
    out = {}
    for i, (arch, cfg, g_np) in enumerate(cases):
        mod = _gnn_module(arch)
        params = mod.init_params(torch.Generator().manual_seed(50 + i), cfg)
        g_cpu, g_dev = to_device(g_np, "cpu"), to_device(g_np, dev)
        p_dev = tree_to(params, dev)
        name = f"{arch} reduced #{i}" + (" remat" if getattr(cfg, "remat",
                                                             False) else "")
        got = path.first(name, lambda: TT.grad(mod.loss_fn, p_dev, g_dev, cfg,
                                               has_aux=False),
                         train_step_launches(arch, cfg, g_dev), grad=True)
        want = TT.grad(mod.loss_fn, params, g_cpu, cfg, has_aux=False)
        g_err = check_close_trees(
            name, got, want, rel=TRAIN_GRAD_REL_L2,
            exact=float64_grad(mod.loss_fn, params, g_cpu, cfg=cfg))
        step = gnn_train_step(mod, cfg, opt)
        p1, _, m1 = step(p_dev, adamw_init(p_dev), g_dev)
        p0, _, _ = step(params, adamw_init(params), g_cpu)
        check_finite_metrics(name, m1)
        out[name] = {"grad_rel_l2": g_err,
                     "param_max_abs_err": check_close_trees(
                         name, p1, p0, atol=TRAIN_PARAM_ATOL)}
    cfg = D.DeepFMConfig(n_sparse=39, embed_dim=10, mlp_dims=(40, 40, 40),
                         rows_per_field=300)
    params = D.init_params(torch.Generator().manual_seed(59), cfg)
    p_dev = tree_to(params, dev)
    bt = {k: torch.from_numpy(v) for k, v in
          CTRPipeline(cfg.n_sparse, cfg.rows_per_field, 256).batch_at(0).items()}
    bt_dev = {k: v.to(dev) for k, v in bt.items()}
    got = path.first("deepfm reduced", lambda: TT.grad(
        D.bce_loss, p_dev, bt_dev["ids"], bt_dev["labels"], cfg,
        has_aux=False), 2, grad=True)
    want = TT.grad(D.bce_loss, params, bt["ids"], bt["labels"], cfg,
                   has_aux=False)
    check(bool(want["table"].any()), "deepfm: no table gradient")
    g_err = check_close_trees(
        "deepfm reduced", got, want, rel=TRAIN_GRAD_REL_L2,
        exact=float64_grad(D.bce_loss, params, bt["ids"], bt["labels"],
                           cfg=cfg))
    step = deepfm_train_step(cfg, opt)
    p1, _, m1 = step(p_dev, adamw_init(p_dev), bt_dev)
    p0, _, _ = step(params, adamw_init(params), bt)
    check_finite_metrics("deepfm reduced", m1)
    out["deepfm reduced"] = {"grad_rel_l2": g_err,
                             "param_max_abs_err": check_close_trees(
                                 "deepfm reduced", p1, p0,
                                 atol=TRAIN_PARAM_ATOL)}
    log(f"train gnn / deepfm reduced, card vs CPU: {out}")
    return out


def gnn_train_timed(dev, path: ModelPath) -> dict:
    """Train steps at published configs and sizes (registry steps,
    DEFAULT_OPT): gat-cora on full_graph_sm, schnet on molecule,
    MeshGraphNet and GraphCast (remat on, float32) at minibatch_lg's device
    dims, DeepFM at train_batch with its full table. Each step's launches
    counted, metrics and new params finite; then timed."""
    from repro_torch import tree as TT
    from repro_torch.configs.registry import (
        DEFAULT_OPT, GNN_SHAPES, RECSYS_SHAPES, _gnn_cfg_for_shape, _gnn_dims,
        _gnn_model_flops, _gnn_module, deepfm_train_step, gnn_train_step)
    from repro_torch.data.graphs import (
        make_full_graph, make_molecule_batch, to_device)
    from repro_torch.data.recsys import CTRPipeline
    from repro_torch.models.recsys import deepfm as D
    from repro_torch.optim.adamw import adamw_init

    sm, mol, lg = (GNN_SHAPES[k] for k in ("full_graph_sm", "molecule",
                                           "minibatch_lg"))
    dims_sm, dims_lg = _gnn_dims("gat-cora", sm, 1), _gnn_dims("graphcast", lg, 1)
    runs = [
        ("gat-cora full_graph_sm", "gat-cora", sm, lambda: make_full_graph(
            "gat-cora", sm["n_nodes"], sm["n_edges"], dims_sm["e"],
            sm["d_feat"], sm["n_classes"]), {}),
        ("schnet molecule", "schnet", mol, lambda: make_molecule_batch(
            "schnet", mol["n_nodes"], mol["n_edges"], mol["batch"],
            mol["n_classes"]), {}),
        ("meshgraphnet minibatch_lg", "meshgraphnet", lg,
         lambda: make_full_graph("meshgraphnet", dims_lg["n"], dims_lg["e"],
                                 dims_lg["e"], lg["d_feat"], lg["n_classes"]),
         {}),
        ("graphcast minibatch_lg remat", "graphcast", lg,
         lambda: make_full_graph("graphcast", dims_lg["n"], dims_lg["e"],
                                 dims_lg["e"], arch_config("graphcast").n_vars,
                                 lg["n_classes"]), {"remat": True}),
    ]
    out = {}
    for i, (name, arch, sh, make, changes) in enumerate(runs):
        mod = _gnn_module(arch)
        cfg = dataclasses.replace(_gnn_cfg_for_shape(
            arch, arch_config(arch), _gnn_dims(arch, sh, 1)), **changes)
        g_np = make()
        g_dev = to_device(g_np, dev)
        params = mod.init_params(torch.Generator(device=dev).manual_seed(60 + i),
                                 cfg)
        state = adamw_init(params)
        step = gnn_train_step(mod, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n_seg = train_step_launches(arch, cfg, g_dev)
        p1, s1, m1 = path.first(name, lambda: step(params, state, g_dev), n_seg,
                                grad=True)
        peak = torch.cuda.max_memory_allocated()
        vals = check_finite_metrics(name, m1)
        check(all(bool(torch.isfinite(p).all()) for p in TT.leaves(p1)),
              f"{name}: a param is not finite after the step")
        del p1, s1
        ms = time_steps(lambda: step(params, state, g_dev), TRAIN_REPEATS)
        breakdown = device_breakdown(lambda: step(params, state, g_dev),
                                     calls=1)
        grads = TT.grad(mod.loss_fn, params, g_dev, cfg, has_aux=False)
        opt = optimizer_ms(grads, state, params, DEFAULT_OPT)
        del grads
        dims = gnn_dims_of(g_np, cfg)
        flops = _gnn_model_flops(arch, cfg, dims)  # 3 forwards
        n_p = sum(p.numel() for p in TT.leaves(params))
        n_bytes = (tree_bytes(list(g_dev[:-1])) + tree_bytes(g_dev.extras)
                   + 32 * n_p)
        seg = ([v for k, v in breakdown.items() if k.startswith(SEGMENT_KERNELS)]
               if isinstance(breakdown, dict) else None)
        out[name] = train_row(
            name, ms, [(flops, F32_FLOPS_PER_S)], n_bytes, breakdown, peak,
            opt, 1, "steps", grad_norm=vals["grad_norm"], params=n_p,
            segment_reduce_launches=n_seg,
            segment_reduce_ms=(round(sum(t for t, _ in seg), 4)
                               if seg is not None else "not measured"),
            recompute_flops=(flops / 3 if getattr(cfg, "remat", False) else 0))
        del params, state, g_dev
        torch.cuda.empty_cache()

    cfg = arch_config("deepfm")
    b = RECSYS_SHAPES["train_batch"]["batch"]
    t = time.perf_counter()
    params = tree_to(D.init_params(torch.Generator().manual_seed(70), cfg), dev)
    torch.cuda.synchronize()
    log(f"deepfm train: {cfg.total_rows} rows drawn on the CPU and copied in "
        f"{time.perf_counter() - t:.2f} s")
    state = adamw_init(params)
    bt = {k: torch.from_numpy(v).to(dev) for k, v in
          CTRPipeline(cfg.n_sparse, cfg.rows_per_field, b).batch_at(0).items()}
    step = deepfm_train_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    p1, s1, m1 = path.first("deepfm train_batch", lambda: step(params, state, bt),
                            2, grad=True)
    peak = torch.cuda.max_memory_allocated()
    vals = check_finite_metrics("deepfm train_batch", m1)
    check(all(bool(torch.isfinite(p).all()) for p in TT.leaves(p1)),
          "deepfm train_batch: a param is not finite after the step")
    del p1, s1
    ms = time_steps(lambda: step(params, state, bt), TRAIN_REPEATS)
    breakdown = device_breakdown(lambda: step(params, state, bt), calls=1)
    grads = TT.grad(D.bce_loss, params, bt["ids"], bt["labels"], cfg,
                    has_aux=False)
    opt = optimizer_ms(grads, state, params, DEFAULT_OPT)
    del grads
    mlp_flops = 2 * sum(a * c for a, c in zip(
        (cfg.n_sparse * cfg.embed_dim,) + cfg.mlp_dims, cfg.mlp_dims + (1,)))
    fm_flops = 4 * cfg.n_sparse * cfg.embed_dim
    n_p = sum(p.numel() for p in TT.leaves(params))
    out["deepfm train_batch"] = train_row(
        "deepfm train_batch", ms, [(3 * b * (mlp_flops + fm_flops),
                                    F32_FLOPS_PER_S)],
        32 * n_p + bt["ids"].numel() * 4 + b * 4, breakdown, peak, opt, b,
        "examples", grad_norm=vals["grad_norm"], params=n_p,
        segment_reduce_launches=2)
    del params, state, bt
    torch.cuda.empty_cache()
    return out


def train_phase(dev) -> dict:
    from repro_torch import kernels

    t0 = time.perf_counter()
    out = {"kernel_autograd": kernel_autograd(dev),
           "lm_reduced": lm_train_reduced(dev),
           "lm_launcher": lm_train_launcher(dev),
           "lm_restart": lm_train_restart(dev),
           "gemma3_1b_2l_f32": lm_train_cut_depth(dev)}
    out["gemma3_1b"] = lm_train_full_width(dev)
    path = ModelPath(kernels)
    out["gnn_recsys_reduced"] = gnn_train_small(dev, path)
    out["gnn_recsys"] = gnn_train_timed(dev, path)
    check(path.launches > 0, "segment_reduce was not launched by a train step")
    secs = time.perf_counter() - t0
    log(f"phase 12 (training): {secs:.1f} s; segment_reduce launched "
        f"{path.launches} times by the GNN and DeepFM train steps")
    out.update(segment_reduce_launches=path.launches, seconds=round(secs, 1))
    return out


# -- phase 13: model exchanges across ranks ------------------------------------

XRANKS = 4
XRANK_AXES = ("data", "model")
# (a) olmoe-1b-7b at full width and depth, bf16, its 64 experts over the
# ranks; the one-process port at ep = 1 on the card is the reference
EP_PROMPT, EP_NEW = 1024, 16
EP_SEED = 40
# neither ep = 4 nor ep = 1 drops at this capacity factor: an expert gets
# at most every token (2,048 rows); its bucket holds n_assign / e_local *
# cf + 8 = 256 cf + 8 rows at either ep, and a rank's bucket at ep = 4
# every assignment from cf = 4
EP_CF_EXACT = 8.0
# bf16 logits, ranks vs one process: the same weights and ops but for the
# expert GEMMs' batch count and where the combine's partial sums meet;
# phase 10's bf16 bound at full depth (LM_FULL_ATOL's reasoning), and a
# greedy token may flip only where the one-process top-two gap is within it
EP_BF16_ATOL = LM_FULL_ATOL
EP_F32_LAYERS, EP_F32_PROMPT, EP_F32_STRIDE = 2, 256, 16
# (b) DeepFM at its published config, the table's rows over the ranks
DEEPFM_SEED = 50
DEEPFM_XRANK_TOL = dict(rtol=1e-5, atol=1e-5)
# the table's gradient through the sharded lookup against the one-process
# scatter-add: float32 sums of up to a few hundred terms (zipf ids hit a
# field's first rows often) in another order, each row within 1e-6 of the
# sum of its terms' magnitudes
DEEPFM_GRAD_RTOL = 1e-6
# (c) graphs of ogb_products' d_feat (100) and mean degree (~25), cut to
# what 4 gloo ranks on one card run in the phase's time; GraphCast on a
# grid near full_graph_sm's (2,708 nodes), rounded to split over the ranks
XRANK_MGN_NODES = 2**17
XRANK_GC_NODES = 4096
XRANK_DEGREE = 25
XRANK_GNN_SEED = 60
XRANK_GNN_REPEATS = 2
# node outputs, ranks vs one process, float32: the shuffle sums in the
# one-process order, but the kernel's chunks (and the streamed sets'
# chunks) round apart; phase 11's minibatch_lg bound on MeshGraphNet
XRANK_GNN_TOL = dict(rtol=1e-4, atol=1e-4)
# the owner-side Reduce of every shuffle scatter (segment_reduce on the
# rows a rank received), held to the plain version on the same rows, in
# blocks of this many segments: float32 to the float64 sum within phase
# 2's bound; bfloat16 (compensated float32 sums rounded once to bf16, half
# an ulp = 2^-9 of the value) to the float64 sum within 2^-8 of it, and
# 1e-4 beside for a crossing segment's float32 partials under cancellation
SCATTER_SEG_BLOCK = 8192
SCATTER_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4),
               torch.bfloat16: dict(rtol=2**-8, atol=1e-4)}
# H100 SXM NVLink 4 (NVIDIA data sheet): 900 GB/s a card, both directions
# together; the bytes a rank must send leave at 450 GB/s at best
NVLINK_BYTES_PER_S = 450e9


def nvlink_ms(remote_bytes: int) -> float:
    """The least time a card's NVLink needs to send `remote_bytes`."""
    return round(remote_bytes / NVLINK_BYTES_PER_S * 1e3, 4)


def CollectiveBytes(timed: bool = False):
    """The package's collective counter (`repro_torch.obs.collectives`),
    imported once src/ is on the path."""
    from repro_torch.obs.collectives import CollectiveBytes as counter

    return counter(timed=timed)


def collective_share(fn, calls: int = 1) -> dict:
    """Per call of `fn` (already warm), in runs of their own: the ms spent
    in its collectives (a synchronize before and after each), the call's
    wall ms in that run, and the share. (The profiler was tried first: it
    slowed a gloo prefill 3.3x, and NCCL's kernels under it wait for
    peers the profiler slowed, so their device time exceeded the step's.)"""
    timed = CollectiveBytes(timed=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with timed:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3 / calls
    coll = timed.seconds * 1e3 / calls
    return {"wall_ms": round(wall, 3), "collective_ms": round(coll, 3),
            "share": round(coll / wall, 4)}


def ep_tokens(dev, vocab: int, shape) -> torch.Tensor:
    return torch.randint(0, vocab, shape, dtype=torch.int32, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             EP_SEED + 1))


def ep_decode(gen, cfg, tokens, ranks=None):
    """Prefill, then greedy steps to EP_NEW tokens, timed (CUDA events
    between them): (tokens (B, EP_NEW), each step's logits on the card,
    prefill ms, step ms, the collectives' counts of the prefill and of the
    steps, one decode step again at the last position (a function))."""
    from repro_torch.models import transformer as T

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(EP_NEW + 1)]
    pre, step = CollectiveBytes(), CollectiveBytes()
    out, logits_at = [], []
    with torch.inference_mode():
        torch.cuda.synchronize()
        ev[0].record()
        with pre:
            nxt, kc, vc = gen.start(tokens)
        ev[1].record()
        out.append(nxt)
        for i in range(1, EP_NEW):
            with step:
                logits = T.decode_logits(gen.params, kc, vc,
                                         EP_PROMPT + i - 1, nxt, cfg, ranks)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            ev[i + 1].record()
            out.append(nxt)
            logits_at.append(logits)
        torch.cuda.synchronize()

    def again():
        with torch.inference_mode():
            T.decode_logits(gen.params, kc, vc, EP_PROMPT + EP_NEW - 2,
                            out[-2], cfg, ranks)

    return (torch.stack(out, dim=1), logits_at, ev[0].elapsed_time(ev[1]),
            [ev[i].elapsed_time(ev[i + 1]) for i in range(1, EP_NEW)],
            pre, step, again)


def ep_rank_runs(ranks) -> dict:
    """(a) on one rank: olmoe-1b-7b's experts over the ranks (ep = world),
    at the published capacity factor (its drops logged) and at
    EP_CF_EXACT (none), the decode with no host sync but the gloo
    exchanges'; timed; and 2 layers in float32."""
    import dataclasses

    from repro_torch.models import transformer as T
    from repro_torch.serve.decode import Generator

    dev = ranks.device
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: a float32 comparison would mean nothing")
    cfg = arch_config("olmoe-1b-7b")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = T.init_params(torch.Generator(device=dev).manual_seed(EP_SEED),
                           cfg, ranks=ranks)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    tokens = ep_tokens(dev, cfg.vocab, (2, EP_PROMPT))
    res = {"param_bytes": param_bytes(params), "init_s": round(init_s, 3),
           "ep": ranks.axis_size("model")}
    published = Generator(cfg, params, device=dev,
                          max_len=EP_PROMPT + EP_NEW, ranks=ranks)
    t = time.perf_counter()
    with torch.inference_mode():
        published.start(tokens)  # the prefill: the sort-based layers
    res["published"] = {
        "capacity_factor": cfg.capacity_factor,
        "dropped": int(published.moe_dropped),
        "assignments": cfg.n_layers * 2 * EP_PROMPT // res["ep"] * cfg.top_k,
        "prefill_cold_s": round(time.perf_counter() - t, 3)}
    exact = dataclasses.replace(cfg, capacity_factor=EP_CF_EXACT)
    gen = Generator(exact, params, device=dev, max_len=EP_PROMPT + EP_NEW,
                    ranks=ranks)
    toks = generate_without_sync(gen, tokens, EP_NEW)
    check(int(gen.moe_dropped) == 0,
          f"olmoe ep={res['ep']} at cf {EP_CF_EXACT} dropped "
          f"{int(gen.moe_dropped)} assignments")
    got, logits_at, pre_ms, step_ms, pre_b, step_b, one_step = ep_decode(
        gen, exact, tokens, ranks)
    steps = max(1, EP_NEW - 1)
    check(torch.equal(got, toks), "olmoe ep: the timed decode's tokens "
          "differ from Generator.generate's")
    p50 = statistics.median(step_ms)
    with torch.inference_mode():
        res.update(
            prefill_ms=round(pre_ms, 3), decode_ms_p50=round(p50, 3),
            decode_ms_min=round(min(step_ms), 3),
            decode_ms_max=round(max(step_ms), 3),
            prefill_exchange_bytes=pre_b.bytes,
            prefill_remote_bytes=pre_b.remote,
            prefill_nvlink_bound_ms=nvlink_ms(pre_b.remote),
            step_exchange_bytes=step_b.bytes // steps,
            step_remote_bytes=step_b.remote // steps,
            peak_bytes=torch.cuda.max_memory_allocated(),
            prefill_collectives=collective_share(lambda: gen.start(tokens)),
            step_collectives=collective_share(one_step, 3))
    del one_step
    if ranks.rank == 0:
        res["tokens"] = toks.cpu()
        res["step_logits"] = [x.float().cpu() for x in logits_at]
    del params, published, gen, logits_at
    torch.cuda.empty_cache()
    # 2 layers in float32
    cfg32 = arch_config("olmoe-1b-7b", n_layers=EP_F32_LAYERS,
                        dtype=torch.float32, capacity_factor=EP_CF_EXACT)
    p32 = T.init_params(torch.Generator(device=dev).manual_seed(EP_SEED + 2),
                        cfg32, ranks=ranks)
    tok32 = ep_tokens(dev, cfg32.vocab, (2, EP_F32_PROMPT))
    with torch.inference_mode():
        lg = T.forward(p32, tok32, cfg32, ranks=ranks)[0]
    if ranks.rank == 0:
        res["f32_logits"] = lg[:, ::EP_F32_STRIDE].cpu()
    del p32, lg
    torch.cuda.empty_cache()
    log(f"rank {ranks.rank} ep: prefill {res['prefill_ms']} ms, decode p50 "
        f"{res['decode_ms_p50']} ms, peak {res['peak_bytes']}, published cf "
        f"dropped {res['published']['dropped']}")
    return res


def ep_reference(dev, rec0: dict) -> dict:
    """(a)'s reference in this process: the one-process port at ep = 1 on
    the card with the same weights (every expert), held to rank 0."""
    import dataclasses

    from repro_torch.models import transformer as T
    from repro_torch.serve.decode import Generator

    published = arch_config("olmoe-1b-7b")
    cfg = dataclasses.replace(published, capacity_factor=EP_CF_EXACT)
    params = T.init_params(torch.Generator(device=dev).manual_seed(EP_SEED),
                           cfg)
    tokens = ep_tokens(dev, cfg.vocab, (2, EP_PROMPT))
    one = Generator(published, params, device=dev,
                    max_len=EP_PROMPT + EP_NEW)
    with torch.inference_mode():
        one.start(tokens)
    gen = Generator(cfg, params, device=dev, max_len=EP_PROMPT + EP_NEW)
    toks = generate_without_sync(gen, tokens, EP_NEW).cpu()
    check(int(gen.moe_dropped) == 0, "olmoe ep=1 dropped assignments")
    got, logits_at, pre_ms, step_ms, _, _, _ = ep_decode(gen, cfg, tokens)
    with torch.inference_mode():
        last = T.forward(params, tokens, cfg)[0][:, -1]
    want_logits = [last.float().cpu()] + [x.float().cpu() for x in logits_at]
    flips, errs = [], []
    for row in range(toks.shape[0]):
        diff = (rec0["tokens"][row] != toks[row]).nonzero()
        last = EP_NEW - 1
        if len(diff):
            last = int(diff[0])
            gap = float(top_two_gap(want_logits[last][row]))
            flips.append((row, last, gap))
            check(gap <= EP_BF16_ATOL,
                  f"olmoe ep row {row} step {last}: tokens differ from the "
                  f"one-process port's with a top-two gap of {gap}")
        # a row's decode logits are comparable up to its first flip (the
        # same history; a decode step drops nothing, so rows do not meet);
        # rank 0 kept steps 1 to EP_NEW - 1
        errs += [float_err(rec0["step_logits"][j - 1][row],
                           want_logits[j][row], rtol=0.0, atol=EP_BF16_ATOL)
                 for j in range(1, last + 1)]
    out = {"tokens_equal": not flips, "flips": flips,
           "one_process_published_dropped": int(one.moe_dropped),
           "logits_max_abs_err": max(errs) if errs else None,
           "one_process_prefill_ms": round(pre_ms, 3),
           "one_process_decode_ms_p50": round(statistics.median(step_ms), 3),
           "one_process_param_bytes": param_bytes(params)}
    del params, gen, one, logits_at, last
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, n_layers=EP_F32_LAYERS,
                                dtype=torch.float32)
    p32 = T.init_params(torch.Generator(device=dev).manual_seed(EP_SEED + 2),
                        cfg32)
    tok32 = ep_tokens(dev, cfg32.vocab, (2, EP_F32_PROMPT))
    with torch.inference_mode():
        want = T.forward(p32, tok32, cfg32)[0][:, ::EP_F32_STRIDE].cpu()
    out["f32_logits_max_abs_err"] = float_err(rec0["f32_logits"], want,
                                              **LM_F32_TOL)
    del p32
    torch.cuda.empty_cache()
    log(f"ep reference (one process, ep=1): {out}")
    return out


def deepfm_lookup_cap(cfg, n_flat: int, n_dev: int, model: int) -> int:
    """The reference's per-destination capacity of its sharded lookup
    (`_build_recsys`'s `make_lookup` in src/repro/configs/registry.py):
    ids past it come back as zero rows there. The port's lookup sizes
    its exchanges exactly and needs none."""
    return max(64, -(-(int(n_flat // n_dev // model
                           * cfg.shuffle_capacity_factor) + 8) // 8) * 8)


def deepfm_batch(cfg, shape: str) -> torch.Tensor:
    from repro_torch.configs.registry import RECSYS_SHAPES
    from repro_torch.data.recsys import CTRPipeline

    b = RECSYS_SHAPES[shape]["batch"]
    return torch.from_numpy(CTRPipeline(cfg.n_sparse, cfg.rows_per_field,
                                        b).batch_at(0)["ids"])


def deepfm_rank_runs(ranks) -> dict:
    """(b) on one rank: DeepFM's tables row-sharded over the ranks (its
    ids' slice of each batch), the lookup against table[ids] bit for bit
    (also on a skewed stream past the reference's capacity), one backward
    through it against the scatter-add, and forward ms at serve_p99 and
    serve_bulk."""
    from repro_torch.models.recsys import deepfm as D

    dev, world, r = ranks.device, ranks.world_size, ranks.rank
    cfg = arch_config("deepfm")
    full = D.init_params(torch.Generator(device=dev).manual_seed(DEEPFM_SEED),
                         cfg)
    shard = {k: (v.clone() if k in ("table", "fm_w") else v)
             for k, v in D.shard_params(full, ranks, cfg).items()}
    lookup = D.make_sharded_lookup(ranks)
    rows = cfg.total_rows // world
    res = {"table_rows_per_rank": rows, "logits": {}, "runs": {}}
    flats = {}
    for shape in ("serve_p99", "serve_bulk"):
        ids = deepfm_batch(cfg, shape)
        b = ids.shape[0] // world
        mine = ids[r * b:(r + 1) * b].to(dev)
        flat = D._flat_ids(mine, cfg)
        flats[shape] = flat
        with torch.inference_mode():
            got, got_w = lookup((shard["table"], shard["fm_w"]), flat)
            check(torch.equal(got, full["table"][flat.long()])
                  and torch.equal(got_w, full["fm_w"][flat.long()]),
                  f"deepfm {shape}: the sharded lookup's rows != table[ids]")
            res["logits"][shape] = D.forward(shard, mine, cfg, lookup).cpu()
    # a skewed stream: every id owned by rank 0's rows, past the cap
    n = flats["serve_p99"].numel()
    skewed = torch.randint(0, rows, (n,), device=dev, dtype=torch.int32,
                           generator=torch.Generator(device=dev).manual_seed(
                               DEEPFM_SEED + 1 + r))
    cap = deepfm_lookup_cap(cfg, n * world, world, world)
    with torch.inference_mode():
        check(torch.equal(lookup((shard["table"],), skewed)[0],
                          full["table"][skewed.long()]),
              "deepfm: the skewed stream's rows != table[ids]")
    res["skewed"] = {"ids_per_rank": n, "reference_cap": cap,
                     "load_on_rank_0_per_sender": n}
    check(n > cap, f"deepfm: the skewed stream ({n} ids a sender to one "
          f"rank) does not pass the reference's cap {cap}")
    # one backward: every rank's ids and weights, so each rank holds the
    # whole scatter-add of its rows
    ids = deepfm_batch(cfg, "serve_p99").to(dev)
    every = D._flat_ids(ids, cfg)
    w = torch.randn((every.numel(), cfg.embed_dim), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(
                        DEEPFM_SEED + 9))
    k = every.numel() // world
    live = shard["table"].clone().requires_grad_(True)
    (lookup((live,), every[r * k:(r + 1) * k])[0]
     * w[r * k:(r + 1) * k]).sum().backward()
    mine = (every >= r * rows) & (every < (r + 1) * rows)
    local = (every[mine] - r * rows).long()
    want = torch.zeros_like(shard["table"]).index_add_(0, local, w[mine])
    scale = torch.zeros_like(want).index_add_(0, local, w[mine].abs())
    err = (live.grad - want).abs()
    res["table_grad_max_abs_err"] = float(err.max())
    check(bool((err <= DEEPFM_GRAD_RTOL * scale).all()),
          f"deepfm: the table's gradient is {res['table_grad_max_abs_err']} "
          "from the scatter-add, past 1e-6 of its terms' magnitudes")
    del full, live, want, scale, err, w
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for shape, flat in flats.items():
        ids = deepfm_batch(cfg, shape)
        b = ids.shape[0] // world
        mine = ids[r * b:(r + 1) * b].to(dev)
        counted = CollectiveBytes()

        def fwd():
            with torch.inference_mode(), counted:
                D.forward(shard, mine, cfg, lookup)

        ms = time_steps(fwd, GNN_REPEATS)
        p50 = statistics.median(ms)
        res["runs"][shape] = {
            "rows_per_rank": b, "forward_ms_p50": round(p50, 4),
            "forward_ms_min": round(min(ms), 4),
            "exchange_bytes_per_call": counted.bytes // GNN_REPEATS,
            "remote_bytes_per_call": counted.remote // GNN_REPEATS,
            "nvlink_bound_ms": nvlink_ms(counted.remote // GNN_REPEATS),
            "collectives": collective_share(fwd, 3)}
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"rank {r} deepfm: {res['runs']}, peak {res['peak_bytes']}")
    return res


def deepfm_reference(dev, recs: list) -> dict:
    """(b)'s reference: the one-process forward on the card, the same
    weights, every rank's logits held to its rows."""
    from repro_torch.models.recsys import deepfm as D

    cfg = arch_config("deepfm")
    params = D.init_params(
        torch.Generator(device=dev).manual_seed(DEEPFM_SEED), cfg)
    out = {}
    for shape in ("serve_p99", "serve_bulk"):
        ids = deepfm_batch(cfg, shape).to(dev)
        with torch.inference_mode():
            want = D.forward(params, ids, cfg).cpu()
        got = torch.cat([rec["deepfm"]["logits"][shape] for rec in recs])
        out[shape] = float_err(got, want, **DEEPFM_XRANK_TOL)
        fn = lambda ids=ids: D.forward(params, ids, cfg)  # noqa: E731
        with torch.inference_mode():
            out[f"{shape}_one_process_ms_p50"] = round(statistics.median(
                time_steps(fn, GNN_REPEATS)), 4)
    del params
    torch.cuda.empty_cache()
    log(f"deepfm reference (one process): logits max abs err {out}")
    return out


def xrank_graph(arch: str, nodes: int, ogb: bool = False):
    """(cfg bound as the registry binds a node-sharded graph, whole graph
    as numpy, stream chunks): ogb_products at its registry dims, or a
    graph of its d_feat and mean degree with `nodes` nodes."""
    from repro_torch.configs.registry import (
        GNN_SHAPES, _gnn_cfg_for_shape, _gnn_dims)
    from repro_torch.data.graphs import make_full_graph

    sh = dict(GNN_SHAPES["ogb_products"])
    if not ogb:
        sh.update(n_nodes=nodes, n_edges=nodes * XRANK_DEGREE)
    dims = dict(_gnn_dims(arch, sh, 1), shard_nodes=True)
    cfg = _gnn_cfg_for_shape(arch, arch_config(arch), dims)
    d_feat = cfg.n_vars if arch == "graphcast" else dims["d_feat"]
    g = make_full_graph(arch, dims["n"], sh["n_edges"], dims["e"], d_feat,
                        sh["n_classes"], seed=XRANK_GNN_SEED)
    return cfg, g, getattr(cfg, "edge_stream_chunks", 0)


class ScatterCalls:
    """While entered: the shuffle scatter's owner-side Reduces
    (`sorted_segment_sum` in `models.gnn.distributed.scatter_add_nodes`),
    the first call of each route (each seg_ids) kept with its rows and a
    copy of its output. The wrapped call is the path's own and launches
    the kernel once, as without the wrapper."""

    def __init__(self):
        from repro_torch.models.gnn import distributed as GD

        self.mod, self.calls = GD, {}

    def __enter__(self):
        self.orig = orig = self.mod.sorted_segment_sum

        def kept(data, ids, n):
            out = orig(data, ids, n)
            if id(ids) not in self.calls:
                self.calls[id(ids)] = (data, ids, n, out.clone())
            return out

        self.mod.sorted_segment_sum = kept
        return self

    def __exit__(self, *exc):
        self.mod.sorted_segment_sum = self.orig


def hold_scatters(name: str, calls: ScatterCalls) -> dict:
    """Each kept Reduce against the plain version (`kernels.segment_reduce
    .ref`) in float64 on the same received rows, SCATTER_SEG_BLOCK
    segments at a time; fails beyond SCATTER_TOL."""
    from repro_torch.kernels.segment_reduce import ref as srr

    worst, rows, routes = 0.0, 0, len(calls.calls)
    for data, ids, n, got in calls.calls.values():
        data = data.reshape(data.shape[0], -1)
        got = got.reshape(n, -1)
        tol = SCATTER_TOL[data.dtype]
        starts = list(range(0, n, SCATTER_SEG_BLOCK)) + [n]
        cuts = torch.searchsorted(ids, torch.tensor(
            starts, dtype=ids.dtype, device=ids.device)).tolist()
        for s0, s1, lo, hi in zip(starts, starts[1:], cuts, cuts[1:]):
            want = srr.sorted_segment_sum(data[lo:hi].double(),
                                          ids[lo:hi] - s0, s1 - s0)
            diff = (got[s0:s1].double() - want).abs()
            check(bool((diff <= tol["atol"] + tol["rtol"] * want.abs())
                       .all()),
                  f"{name}: segment_reduce's scatter Reduce (rows "
                  f"{data.shape[0]}, width {data.shape[1]}, segments {n}, "
                  f"{data.dtype}) beyond rtol={tol['rtol']} "
                  f"atol={tol['atol']} of the plain version")
            worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
        rows += data.shape[0]
    calls.calls.clear()
    return {"routes": routes, "rows": rows, "max_abs_err": worst}


def gnn_rank_runs(ranks, ogb: bool) -> dict:
    """(c) on one rank: MeshGraphNet and GraphCast (streamed) node-sharded
    with the shuffle, bf16 and remat as the registry binds them: the
    first forward with no host sync but the gloo exchanges', launching
    segment_reduce once per aggregation, each scatter route's Reduce in
    it held to the plain version (`hold_scatters`); timed; and in
    float32, the same, and the rank's node outputs for the one-process
    comparison. With `ogb`, MeshGraphNet alone at ogb_products' registry
    dims, bf16 only."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs.registry import _gnn_model_flops, _gnn_module
    from repro_torch.data.graphs import shard_graph

    runs = [("meshgraphnet", XRANK_MGN_NODES)]
    if not ogb:
        runs.append(("graphcast", XRANK_GC_NODES))
    out = {"launches": 0}
    for arch, nodes in runs:
        t = time.perf_counter()
        cfg, g, chunks = xrank_graph(arch, nodes, ogb)
        gs = shard_graph(g, ranks, chunks)
        mod = _gnn_module(arch)
        params = mod.init_params(torch.Generator(device=ranks.device)
                                 .manual_seed(XRANK_GNN_SEED + 1), cfg)
        routes = gs.extras["routes"]
        want = cfg.n_layers if arch == "meshgraphnet" else (
            cfg.n_layers + len(routes["g2m"].scatter)
            + len(routes["m2g"].scatter))
        built_s = time.perf_counter() - t
        res = {"nodes": g.n_nodes, "edges": g.n_edges,
               "local_nodes": gs.n_nodes, "local_edges": gs.n_edges,
               "build_s": round(built_s, 2)}
        for label, c in (("bf16", cfg), ("float32", dataclasses.replace(
                cfg, compute_dtype=torch.float32))):
            if ogb and label == "float32":
                continue
            fn = lambda c=c: mod.apply(params, gs, c, ranks=ranks)  # noqa: E731
            clear_launches(kernels)
            with ScatterCalls() as calls:
                y = run_without_sync(fn)
            got = kernels.LAUNCHES["segment_reduce"]
            clear_launches(kernels)
            check(got == want, f"{arch} {label} rank {ranks.rank}: "
                  f"segment_reduce launched {got} times, its aggregations "
                  f"need {want}")
            out["launches"] += got
            held = hold_scatters(f"{arch} {label} rank {ranks.rank}", calls)
            n_routes = sum(len(r.scatter) for r in routes.values())
            check(held["routes"] == n_routes,
                  f"{arch} {label}: {held['routes']} of the {n_routes} "
                  "scatter routes held to the plain version")
            res[f"scatter_reduce_{label}"] = held
            check(bool(torch.isfinite(y).all()),
                  f"{arch} {label}: outputs not finite")
            if label == "float32":
                res["y"] = y.cpu()
                continue
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counted = CollectiveBytes()

            def once():
                with torch.inference_mode(), counted:
                    fn()

            ms = time_steps(once, XRANK_GNN_REPEATS)
            # a rank's share of the model FLOPs, at the float32 rate (bf16
            # activations meet float32 weights)
            flops = _gnn_model_flops(arch, cfg, gnn_dims_of(gs, cfg)) / 3
            b_ms = flops / F32_FLOPS_PER_S * 1e3
            p50 = statistics.median(ms)
            res[label] = {
                "forward_ms_p50": round(p50, 4),
                "forward_ms_min": round(min(ms), 4),
                "bound_ms": round(b_ms, 4), "bound_by": "operations",
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "exchange_bytes_per_forward": counted.bytes // len(ms),
                "remote_bytes_per_forward": counted.remote // len(ms),
                "nvlink_bound_ms": nvlink_ms(counted.remote // len(ms)),
                "collective_calls_per_forward": counted.calls // len(ms),
                "segment_reduce_launches": got,
                "collectives": collective_share(once)}
        out[arch] = res
        log(f"rank {ranks.rank} {arch}: {res.get('bf16')}; scatter "
            f"Reduces held to the plain version: bf16 "
            f"{res['scatter_reduce_bf16']}, float32 "
            f"{res.get('scatter_reduce_float32')}")
        del params, gs, g
        torch.cuda.empty_cache()
    return out


def gnn_reference(dev, recs: list) -> dict:
    """(c)'s reference: each arch's float32 forward in one process on the
    whole graph, the same weights, against the ranks' outputs."""
    import dataclasses

    from repro_torch.configs.registry import _gnn_module
    from repro_torch.data.graphs import to_device

    out = {}
    for arch, nodes in (("meshgraphnet", XRANK_MGN_NODES),
                        ("graphcast", XRANK_GC_NODES)):
        cfg, g, _ = xrank_graph(arch, nodes)
        one = dataclasses.replace(cfg, node_spec=(), shuffle_gather=False,
                                  compute_dtype=torch.float32)
        mod = _gnn_module(arch)
        params = mod.init_params(torch.Generator(device=dev)
                                 .manual_seed(XRANK_GNN_SEED + 1), one)
        with torch.inference_mode():
            want = mod.apply(params, to_device(g, dev), one).cpu()
        got = torch.cat([rec["gnn"][arch]["y"] for rec in recs])
        out[arch] = float_err(got, want, **XRANK_GNN_TOL)
        del params
        torch.cuda.empty_cache()
    log(f"gnn reference (one process, float32): outputs max abs err {out}")
    return out


def exchange_rank_prog(ranks, ogb: bool) -> dict:
    """Phase 13 on one rank: (a), (b) and (c) in turn."""
    t = time.perf_counter()
    out = {"rank": ranks.rank, "ep": ep_rank_runs(ranks),
           "deepfm": deepfm_rank_runs(ranks),
           "gnn": gnn_rank_runs(ranks, ogb)}
    out["wall_s"] = round(time.perf_counter() - t, 1)
    return out


def exchange_phase(dev, nccl: bool = False) -> dict:
    """Phase 13: the model's exchanges across ranks. One card: 4 ranks
    sharing it over gloo (staged through the host; NCCL refuses two ranks
    on one card), spawned once, every path on every rank; `nccl`: one
    NCCL rank a card, MeshGraphNet at ogb_products' registry dims. The
    references run in this process after the ranks are gone."""
    t0 = time.perf_counter()
    world = torch.cuda.device_count() if nccl else XRANKS
    recs = spawn_ranks(world, "exchange_rank_prog", nccl,
                       device=None if nccl else str(dev),
                       backend=None if nccl else "gloo",
                       axis_sizes=(1, world), axis_names=XRANK_AXES)
    ranks_s = time.perf_counter() - t0
    out = {"world": world, "backend": "nccl" if nccl else "gloo",
           "ranks_wall_s": round(ranks_s, 1),
           "segment_reduce_launches": sum(r["gnn"]["launches"]
                                          for r in recs)}
    check(out["segment_reduce_launches"] > 0,
          "phase 13: segment_reduce was not launched")
    out["ep_reference"] = ep_reference(dev, recs[0]["ep"])
    out["deepfm_reference"] = deepfm_reference(dev, recs)
    if not nccl:
        out["gnn_reference"] = gnn_reference(dev, recs)
    for rec in recs:
        rec["ep"].pop("tokens", None)
        rec["ep"].pop("step_logits", None)
        rec["ep"].pop("f32_logits", None)
        rec["deepfm"].pop("logits")
        for arch in ("meshgraphnet", "graphcast"):
            rec["gnn"].get(arch, {}).pop("y", None)
    out["ranks"] = recs
    out["seconds"] = round(time.perf_counter() - t0, 1)
    log(f"phase 13 (model exchanges across {world} ranks, "
        f"{out['backend']}): {out['seconds']} s, segment_reduce launched "
        f"{out['segment_reduce_launches']} times on the ranks")
    return out


# -- phase 14: training across ranks -------------------------------------------

TRANKS = 4
TRAIN_AXES = ("data", "model")
# (a) the reference's mesh program's config (tests/distributed/lm_mesh_prog.py:
# 6 experts, capacity factor 8, vocab 250 padded to 256) in float32 on three
# meshes, 2 steps, held to the one-process step on the card: loss, grad_norm
# and the params (the relative L2 error of the whole tree) within 1e-5, and
# each param leaf within 1e-3 of its own norm. AdamW's first steps divide
# each element by its own magnitude plus eps (1e-8), and a third of the
# embedding's gradient elements are 0 or near 1e-8 (tokens a batch does not
# use, or uses once), so the sums' order moves such an element by up to
# lr: 5.5e-5 of a zero-initialized norm weight's leaf in a CPU rehearsal.
# A wrong or missing gradient moves a leaf by O(lr) in every element: O(1)
# of a zero-initialized leaf, far past 1e-3
TRAIN_MESHES = ((2, 2), (4, 1), (1, 4))
TRAIN_MESH_RTOL, TRAIN_LEAF_RTOL = 1e-5, 1e-3
TRAIN_MESH_BATCH, TRAIN_MESH_SEQ, TRAIN_MESH_STEPS = 8, 32, 2
# (b) gemma3-1b at full width (depth below), bf16, remat, DEFAULT_OPT: the
# global batch 4 x 1024 (--train-ranks-nccl: train_4k's sequence, 4 x
# 4096), 2 steps at (data 4) with ZeRO-1 and a checkpoint at step 1 (3
# steps and a checkpoint at step 2 took phase 14 past its 200 s: 203.6 s,
# run D), 1 at (data 2, model 2) with the sequence cut; bf16 sums in
# another order: the reference's invariance bound on the loss, 1e-2 on
# grad_norm
GEMMA_X_BATCH, GEMMA_X_SEQ, GEMMA_X_NCCL_SEQ = 4, 1024, 4096
GEMMA_X_STEPS, GEMMA_X_CKPT = 2, 1
# on gloo the depth is cut to 13 of 26 layers (6 and 12 global, as the
# 5:1 pattern places them): at full depth the whole smoke took 922.5 s of
# its 900 s budget (run F), 64 s of phase 14's 171.2 in the 10 GB
# checkpoint's write and restore; NCCL runs the full depth
GEMMA_X_GLOO_LAYERS = 13
GEMMA_X_LOSS_RTOL, GEMMA_X_GNORM_RTOL = 2e-3, 1e-2
# (c) qwen2.5-32b at full width with its FSDP and the chunked loss, depth
# cut to 1 layer (2.04 B params: at 2 layers, 2.53 B, four ranks' state and
# the functional AdamW's new state did not fit one card: 17.0 GB a rank,
# run A), 4 x 512 (2 x 1024 does not split over 4 data ranks; the same
# 2,048 tokens), 1 step at (data 4)
QWEN_X_LAYERS, QWEN_X_BATCH, QWEN_X_SEQ = 1, 4, 512
# (d) phase 13's gloo graphs, float32, 1 step of `train_opt` (lr 3e-3),
# MeshGraphNet's cut to 2^15 nodes (its step took 32.7 s a rank at 2^17,
# run D in PERF.md, and 16.7 s at 2^16, run F, whose whole smoke passed
# 900 s): grad_norm within 1e-5 of the one-process step's; the params
# (relative L2 of the tree) within 3e-4 and each leaf within 1e-2 of its
# norm. AdamW's first step moves an element by lr * g / (|g| + 1e-8), so
# an element whose gradient, a sum over every edge, cancels to near 0
# moves by up to 2 lr when a float32 sum in another order flips its sign:
# the sound run H read 1.0e-4 of the tree and 2.9e-3 of a leaf
# (GraphCast's zero-initialized g2m edge bias; MeshGraphNet 1.3e-5 and
# 2.1e-4). A wrong or missing gradient moves every element of its leaf by
# O(lr): O(1) of a zero-initialized leaf, ~0.1 of a weight's
TRAIN_GNN_RTOL, TRAIN_GNN_LEAF_RTOL, TRAIN_GNN_GNORM_RTOL = 3e-4, 1e-2, 1e-5
TRAIN_MGN_NODES = 2**15
# (e) DeepFM at its published config and train_batch over (1, 4), 1 step of
# `train_opt`: grad_norm within 1e-6 of the one-process step's; the rows
# the batch updates, a sample of the others and the dense weights within
# 2e-5 (sums of up to a few hundred terms in another order, then AdamW's
# first step, lr times a sign where a gradient is not near 0: run H read
# 5.5e-6); a wrong gradient moves an element by O(lr), 3e-3
DEEPFM_TRAIN_ATOL, DEEPFM_TRAIN_GNORM_RTOL = 2e-5, 1e-6
DEEPFM_TRAIN_SAMPLE = 4096


def tree_rel_err(name: str, got: list, want, rtol: float,
                 leaf_rtol: float) -> float:
    """The relative L2 error of a tree of leaves (`got`, in `want`'s leaf
    order) against `want`'s, within `rtol`, each leaf's of its own norm
    within `leaf_rtol`; fails beyond either, and logs the worst leaf."""
    from repro_torch import tree as TT

    diff2 = norm2 = 0.0
    worst = (0.0, "")
    for path, g, w in zip(TT.paths(want), got, TT.leaves(want)):
        d, n = float((g - w).float().norm()), float(w.float().norm())
        worst = max(worst, (d / max(n, 1e-30), path))
        diff2, norm2 = diff2 + d * d, norm2 + n * n
    err = (diff2 / norm2) ** 0.5
    log(f"{name}: params {err} off one process; worst leaf {worst[1]} "
        f"{worst[0]} of its norm")
    check(err <= rtol, f"{name}: params {err} off one process")
    check(worst[0] <= leaf_rtol, f"{name}: {worst[1]} {worst[0]} of its "
          "norm off one process")
    return err


def mesh_lm_config():
    from repro_torch.models import transformer as T

    return T.TransformerConfig(
        name="mesh-test", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
        d_head=8, d_ff=64, vocab=250, n_experts=6, top_k=2, d_expert_ff=32,
        capacity_factor=8.0, kv_chunk=8, remat=True, dtype=torch.float32)


def train_opt():
    """(a), (d) and (e)'s optimizer, the CPU tests' (lr 3e-3 from the
    first step, so a wrong or missing gradient moves a leaf by O(lr));
    in (a) every step clips (clip_norm under the gradients' norm of
    ~1.4)."""
    from repro_torch.optim.adamw import AdamWConfig

    return AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10,
                       clip_norm=0.5)


def mesh_lm_batches(dev) -> list[dict]:
    gen = torch.Generator(device=dev).manual_seed(1)
    return [{k: torch.randint(0, 250, (TRAIN_MESH_BATCH, TRAIN_MESH_SEQ),
                              generator=gen, device=dev, dtype=torch.int32)
             for k in ("tokens", "labels")}
            for _ in range(TRAIN_MESH_STEPS)]


def rows_of(batch: dict, ranks) -> dict:
    from repro_torch.data.tokens import data_rows

    return data_rows(batch, ranks.axis_index("data"), ranks.axis_size("data"))


def whole_leaves(tree, specs, ranks) -> list:
    from repro_torch import tree as TT
    from repro_torch.core import specs as S

    return [S.gather(x, s, ranks).cpu() for x, s in zip(
        TT.leaves(tree), S.spec_leaves(specs, tree))]


def mesh_lm_rank_runs(ranks) -> dict:
    """(a) on one rank: the reduced MoE LM in float32 on each mesh, 2
    steps from the same seeded weights; metrics and (rank 0) the whole
    params after each step."""
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_init

    cfg, out = mesh_lm_config(), {}
    for sizes in TRAIN_MESHES:
        mesh = ranks.remesh(sizes, TRAIN_AXES)
        specs = T.param_specs(cfg, False, sizes[1])
        whole = T.init_params(torch.Generator(device=ranks.device)
                              .manual_seed(0), cfg, ep=sizes[1])
        params = T.shard_params(whole, mesh, specs)
        state = adamw_init(params, specs, mesh)
        step = T.make_train_step(cfg, train_opt(), ranks=mesh)
        steps = []
        for b in mesh_lm_batches(ranks.device):
            params, state, m = step(params, state, rows_of(b, mesh))
            rec = {k: float(m[k]) for k in ("loss", "grad_norm", "aux")}
            if ranks.rank == 0:
                rec["params"] = whole_leaves(params, specs, mesh)
            else:
                whole_leaves(params, specs, mesh)  # every rank gathers
            steps.append(rec)
        out[sizes] = steps
    return out


def mesh_lm_reference(dev, recs: list) -> dict:
    """(a)'s reference: the one-process step on the card, each mesh's
    expert padding, held to every rank's metrics and rank 0's params."""
    from repro_torch import tree as TT
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_init

    cfg, out = mesh_lm_config(), {}
    for sizes in TRAIN_MESHES:
        params = T.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg, ep=sizes[1])
        state = adamw_init(params)
        step = T.make_train_step(cfg, train_opt())
        worst = {"loss": 0.0, "grad_norm": 0.0, "params": 0.0}
        for k, b in enumerate(mesh_lm_batches(dev)):
            params, state, m = step(params, state, b)
            want = {n: float(m[n]) for n in ("loss", "grad_norm")}
            check(want["grad_norm"] > train_opt().clip_norm,
                  f"train mesh {sizes}: step {k + 1} does not clip")
            for rec in recs:
                got = rec["mesh_lm"][sizes][k]
                for n in ("loss", "grad_norm"):
                    err = abs(got[n] - want[n]) / abs(want[n])
                    check(err <= TRAIN_MESH_RTOL, f"train mesh {sizes} "
                          f"step {k + 1} rank {rec['rank']}: {n} "
                          f"{got[n]} vs one process {want[n]}")
                    worst[n] = max(worst[n], err)
            got = recs[0]["mesh_lm"][sizes][k]["params"]
            err = tree_rel_err(f"train mesh {sizes} step {k + 1}",
                               [g.to(dev) for g in got], params,
                               TRAIN_MESH_RTOL, TRAIN_LEAF_RTOL)
            worst["params"] = max(worst["params"], err)
        out[f"{sizes[0]}x{sizes[1]}"] = worst
    log(f"train (a) reduced MoE LM float32 across ranks vs one process, "
        f"relative errors: {out}")
    return out


def gemma_x_config(nccl: bool):
    """(b)'s gemma3-1b: full width, the depth cut on gloo."""
    cfg = arch_config("gemma3-1b")
    if nccl:
        return cfg
    return dataclasses.replace(cfg, n_layers=GEMMA_X_GLOO_LAYERS)


def gemma_x_batches(seq: int) -> list[dict]:
    from repro_torch.data.tokens import TokenPipeline

    pipe = TokenPipeline(vocab=arch_config("gemma3-1b").vocab,
                         batch=GEMMA_X_BATCH, seq=seq)
    return [pipe.batch_at(k) for k in range(GEMMA_X_STEPS)]


def on_card(batch: dict, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def timed_step(step, params, state, batch, counted=None):
    """One train step with CUDA events around it (ms) and its metrics on
    the host; `counted` (a CollectiveBytes) counts its collectives."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    with counted or contextlib.nullcontext():
        params, state, m = step(params, state, batch)
    ev[1].record()
    torch.cuda.synchronize()
    return params, state, {k: float(v) for k, v in m.items()}, \
        ev[0].elapsed_time(ev[1])


def gemma_rank_runs(ranks, seq: int, ckpt_dir: str, nccl: bool) -> dict:
    """(b) on one rank: gemma3-1b at (data 4) with ZeRO-1 for
    GEMMA_X_STEPS steps, a checkpoint of step GEMMA_X_CKPT written across
    the ranks, the last step's collectives counted and timed; then 1 step
    at (data 2, model 2) with the sequence cut over "model"."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.registry import DEFAULT_OPT
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_init, state_specs

    dev = ranks.device
    cfg = gemma_x_config(nccl)
    batches = gemma_x_batches(seq)
    out = {}
    for sizes, n_steps in (((4, 1), GEMMA_X_STEPS), ((2, 2), 1)):
        mesh = ranks.remesh(sizes, TRAIN_AXES)
        specs = T.param_specs(cfg, False, sizes[1])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = T.shard_params(T.init_params(
            torch.Generator(device=dev).manual_seed(0), cfg), mesh, specs)
        state = adamw_init(params, specs, mesh)
        step = T.make_train_step(cfg, DEFAULT_OPT, ranks=mesh)
        rec = {"steps": [], "ms": []}
        for k in range(n_steps):
            b = on_card(rows_of(batches[k], mesh), dev)
            # the last step's collectives counted and timed (a synchronize
            # around each; gloo's block the host anyway)
            counted = (CollectiveBytes(timed=True) if k == n_steps - 1
                       else None)
            params, state, m, ms = timed_step(step, params, state, b,
                                              counted)
            rec["steps"].append({n: m[n] for n in ("loss", "grad_norm")})
            rec["ms"].append(round(ms, 3))
            if counted is not None:
                rec["collective_bytes"] = counted.bytes
                rec["remote_bytes"] = counted.remote
                rec["nvlink_bound_ms"] = nvlink_ms(counted.remote)
                rec["collective_calls"] = counted.calls
                rec["collectives"] = {
                    "collective_ms": round(counted.seconds * 1e3, 3),
                    "share": round(counted.seconds * 1e3 / ms, 4)}
            if sizes == (4, 1) and k + 1 == GEMMA_X_CKPT:
                mgr = CheckpointManager(ckpt_dir, keep_k=1)
                t = time.perf_counter()
                mgr.save(k + 1, {"params": params, "opt": state},
                         extra_meta={"pipeline": {"step": k + 1}},
                         ranks=mesh, specs={
                             "params": specs,
                             "opt": state_specs(params, specs, mesh)})
                mgr.wait()
                rec["checkpoint_s"] = round(time.perf_counter() - t, 2)
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        out[f"{sizes[0]}x{sizes[1]}"] = rec
        del params, state, step
        log(f"rank {ranks.rank} gemma3-1b {sizes}: {rec}")
    torch.cuda.empty_cache()
    return out


def gemma_reference(dev, recs: list, seq: int, ckpt_dir: str,
                    nccl: bool) -> dict:
    """(b)'s reference: the one-process step on the card from the seeded
    weights (step 1, timed warm), held to both meshes' step 1; then the
    ranks' checkpoint restored in one process and its next step held to
    the ranks' last."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.registry import DEFAULT_OPT
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_init

    cfg = gemma_x_config(nccl)
    batches = gemma_x_batches(seq)
    n_micro = 1 if seq <= GEMMA_X_SEQ else 2
    step = T.make_train_step(cfg, DEFAULT_OPT, n_micro=n_micro)
    loss_fn = T.make_loss_fn(cfg)

    def loss_of(params, batch) -> float:
        """The batch's mean nll (the ranks' loss metric): the step's own at
        one micro-batch, else the mean of each half's."""
        mb = batch["tokens"].shape[0] // n_micro
        with torch.no_grad():
            return statistics.fmean(float(loss_fn(
                params, batch["tokens"][i:i + mb],
                batch["labels"][i:i + mb])[1]["loss"])
                for i in range(0, batch["tokens"].shape[0], mb))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    state = adamw_init(params)
    b = on_card(batches[0], dev)
    _, _, m1, cold = timed_step(step, params, state, b)
    _, _, m1, warm = timed_step(step, params, state, b)
    if n_micro > 1:
        m1["loss"] = loss_of(params, b)
    out = {"one_card_step_ms": [round(cold, 3), round(warm, 3)],
           "one_card_peak_bytes": torch.cuda.max_memory_allocated(),
           "one_card_step1": {n: m1[n] for n in ("loss", "grad_norm")}}
    del params, state

    def hold(label, got, want):
        for n, rtol in (("loss", GEMMA_X_LOSS_RTOL),
                        ("grad_norm", GEMMA_X_GNORM_RTOL)):
            err = abs(got[n] - want[n]) / abs(want[n])
            check(err <= rtol, f"gemma3-1b {label}: {n} {got[n]} vs one "
                  f"process {want[n]} (rtol {rtol})")
            out[f"{label} {n} rel err"] = round(err, 7)

    for rec in recs:
        for mesh in ("4x1", "2x2"):
            hold(f"{mesh} step 1 rank {rec['rank']}",
                 rec["gemma"][mesh]["steps"][0], m1)
    torch.cuda.empty_cache()
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    like = {"params": params, "opt": adamw_init(params)}
    mgr = CheckpointManager(ckpt_dir, keep_k=1)
    check(mgr.all_steps() == [GEMMA_X_CKPT],
          f"gemma3-1b: the ranks' checkpoints {mgr.all_steps()}")
    t = time.perf_counter()
    back = mgr.restore(GEMMA_X_CKPT, like)
    torch.cuda.synchronize()
    out["restore_at_world_1_s"] = round(time.perf_counter() - t, 2)
    del like, params
    b = on_card(batches[GEMMA_X_CKPT], dev)
    _, _, m3, _ = timed_step(step, back["params"], back["opt"], b)
    if n_micro > 1:
        m3["loss"] = loss_of(back["params"], b)
    out["one_card_after_restore"] = {n: m3[n] for n in ("loss",
                                                        "grad_norm")}
    for rec in recs:
        hold(f"4x1 step {GEMMA_X_CKPT + 1} rank {rec['rank']}",
             rec["gemma"]["4x1"]["steps"][GEMMA_X_CKPT], m3)
    del back
    torch.cuda.empty_cache()
    log(f"train (b) gemma3-1b across ranks vs one card: {out}")
    return out


def qwen_rank_runs(ranks) -> dict:
    """(c) on one rank: qwen2.5-32b at full width, 1 layer, its FSDP
    ("data" cuts of every weight, gathered block by block, again in the
    remat) and ZeRO-1 at (data 4): one step, its collectives counted."""
    from repro_torch.configs.registry import DEFAULT_OPT
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_init

    dev = ranks.device
    cfg = arch_config("qwen2.5-32b", n_layers=QWEN_X_LAYERS)
    check(cfg.fsdp and cfg.ce_chunk > 0, "qwen2.5-32b: FSDP, chunked loss")
    mesh = ranks.remesh((4, 1), TRAIN_AXES)
    specs = T.param_specs(cfg, False, 1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = T.shard_params(T.init_params(
        torch.Generator(device=dev).manual_seed(0), cfg), mesh, specs)
    torch.cuda.empty_cache()
    state = adamw_init(params, specs, mesh)
    step = T.make_train_step(cfg, DEFAULT_OPT, ranks=mesh)
    batch = TokenPipeline(vocab=cfg.vocab, batch=QWEN_X_BATCH,
                          seq=QWEN_X_SEQ).batch_at(0)
    counted = CollectiveBytes()
    _, _, m, ms = timed_step(step, params, state,
                             on_card(rows_of(batch, mesh), dev), counted)
    rec = {"loss": m["loss"], "grad_norm": m["grad_norm"],
           "step_ms": round(ms, 3),
           "param_bytes": tree_bytes(params),
           "opt_bytes": tree_bytes([state["m"], state["v"]]),
           "collective_bytes": counted.bytes, "remote_bytes": counted.remote,
           "nvlink_bound_ms": nvlink_ms(counted.remote),
           "collective_calls": counted.calls,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    del params, state, step
    torch.cuda.empty_cache()
    log(f"rank {ranks.rank} qwen2.5-32b {QWEN_X_LAYERS} layer(s) FSDP "
        f"(4, 1): {rec}")
    return rec


def qwen_reference(dev, recs: list) -> dict:
    """(c)'s reference: the one-process step on the card."""
    from repro_torch.configs.registry import DEFAULT_OPT
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_init

    cfg = arch_config("qwen2.5-32b", n_layers=QWEN_X_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    state = adamw_init(params)
    batch = on_card(TokenPipeline(vocab=cfg.vocab, batch=QWEN_X_BATCH,
                                  seq=QWEN_X_SEQ).batch_at(0), dev)
    _, _, m, ms = timed_step(T.make_train_step(cfg, DEFAULT_OPT), params,
                             state, batch)
    out = {"one_card_step_ms": round(ms, 3),
           "one_card_peak_bytes": torch.cuda.max_memory_allocated(),
           "params": T.count_params(cfg)[0],
           "loss": m["loss"], "grad_norm": m["grad_norm"]}
    del params, state
    torch.cuda.empty_cache()
    for rec in recs:
        got = rec["qwen"]
        for n, rtol in (("loss", GEMMA_X_LOSS_RTOL),
                        ("grad_norm", GEMMA_X_GNORM_RTOL)):
            err = abs(got[n] - m[n]) / abs(m[n])
            check(err <= rtol, f"qwen2.5-32b rank {rec['rank']}: {n} "
                  f"{got[n]} vs one process {m[n]} (rtol {rtol})")
            out[f"rank {rec['rank']} {n} rel err"] = round(err, 7)
    log(f"train (c) qwen2.5-32b FSDP across ranks vs one card: {out}")
    return out


def gnn_train_rank_runs(ranks) -> dict:
    """(d) on one rank: one float32 train step of MeshGraphNet and of
    GraphCast (streamed), node-sharded with the shuffle and remat as the
    registry binds them: segment_reduce launched once per aggregation in
    the forward and again in the remat, each scatter route's Reduce held
    to the plain version; the new params and grad_norm."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch import tree as TT
    from repro_torch.configs.registry import _gnn_module, gnn_train_step
    from repro_torch.data.graphs import shard_graph
    from repro_torch.optim.adamw import adamw_init

    out = {"launches": 0}
    for arch, nodes in (("meshgraphnet", TRAIN_MGN_NODES),
                        ("graphcast", XRANK_GC_NODES)):
        cfg, g, chunks = xrank_graph(arch, nodes)
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
        check(cfg.remat and cfg.shuffle_gather, f"{arch}: remat, shuffle")
        gs = shard_graph(g, ranks, chunks)
        mod = _gnn_module(arch)
        params = mod.init_params(torch.Generator(device=ranks.device)
                                 .manual_seed(XRANK_GNN_SEED + 1), cfg)
        routes = gs.extras["routes"]
        per_forward = cfg.n_layers if arch == "meshgraphnet" else (
            cfg.n_layers + len(routes["g2m"].scatter)
            + len(routes["m2g"].scatter))
        step = gnn_train_step(mod, cfg, train_opt(), ranks=ranks)
        torch.cuda.reset_peak_memory_stats()
        clear_launches(kernels)
        counted = CollectiveBytes()
        with ScatterCalls() as calls:
            new, _, m, ms = timed_step(step, params, adamw_init(params), gs,
                                       counted)
        got = kernels.LAUNCHES["segment_reduce"]
        clear_launches(kernels)
        check(got == 2 * per_forward, f"{arch} train step rank "
              f"{ranks.rank}: segment_reduce launched {got} times; the "
              f"forward's {per_forward} aggregations and the remat's need "
              f"{2 * per_forward}")
        out["launches"] += got
        held = hold_scatters(f"{arch} train step rank {ranks.rank}", calls)
        n_routes = sum(len(r.scatter) for r in routes.values())
        check(held["routes"] == n_routes, f"{arch} train step: "
              f"{held['routes']} of the {n_routes} scatter routes held")
        out[arch] = {
            "step_ms": round(ms, 3), "grad_norm": m["grad_norm"],
            "segment_reduce_launches": got, "scatter_reduce": held,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "collective_bytes": counted.bytes, "remote_bytes": counted.remote,
            "params": [p.cpu() for p in TT.leaves(new)]}
        log(f"rank {ranks.rank} {arch} float32 train step: "
            f"{ {k: v for k, v in out[arch].items() if k != 'params'} }")
        del params, new, gs, g
        torch.cuda.empty_cache()
    return out


def gnn_train_reference(dev, recs: list) -> dict:
    """(d)'s reference: each arch's float32 step in one process on the
    whole graph, the same weights; every rank's params against it."""
    import dataclasses

    from repro_torch import tree as TT
    from repro_torch.configs.registry import _gnn_module, gnn_train_step
    from repro_torch.data.graphs import to_device
    from repro_torch.optim.adamw import adamw_init

    out = {}
    for arch, nodes in (("meshgraphnet", TRAIN_MGN_NODES),
                        ("graphcast", XRANK_GC_NODES)):
        cfg, g, _ = xrank_graph(arch, nodes)
        one = dataclasses.replace(cfg, node_spec=(), shuffle_gather=False,
                                  compute_dtype=torch.float32)
        mod = _gnn_module(arch)
        params = mod.init_params(torch.Generator(device=dev)
                                 .manual_seed(XRANK_GNN_SEED + 1), one)
        step = gnn_train_step(mod, one, train_opt())
        new, _, m, ms = timed_step(step, params, adamw_init(params),
                                   to_device(g, dev))
        worst = 0.0
        for rec in recs:
            got = rec["gnn"][arch]
            err = abs(got["grad_norm"] - m["grad_norm"]) / m["grad_norm"]
            check(err <= TRAIN_GNN_GNORM_RTOL, f"{arch} rank {rec['rank']}: "
                  f"grad_norm {got['grad_norm']} vs {m['grad_norm']}")
            worst = max(worst, tree_rel_err(
                f"{arch} rank {rec['rank']}",
                [a.to(dev) for a in got["params"]], new, TRAIN_GNN_RTOL,
                TRAIN_GNN_LEAF_RTOL))
        moved = sum(float((a - b).float().norm()) ** 2 for a, b in zip(
            TT.leaves(new), TT.leaves(params))) ** 0.5
        out[arch] = {"one_card_step_ms": round(ms, 3),
                     "grad_norm_rel_err": round(err, 9),
                     "params_rel_err": worst,
                     "step_rel_size": moved / sum(
                         float(w.float().norm()) ** 2
                         for w in TT.leaves(new)) ** 0.5}
        del params, new
        torch.cuda.empty_cache()
    log(f"train (d) GNN steps across ranks vs one card: {out}")
    return out


def deepfm_train_batch() -> dict:
    from repro_torch.configs.registry import RECSYS_SHAPES
    from repro_torch.data.recsys import CTRPipeline

    cfg = arch_config("deepfm")
    return CTRPipeline(cfg.n_sparse, cfg.rows_per_field,
                       RECSYS_SHAPES["train_batch"]["batch"]).batch_at(0)


def deepfm_train_rank_runs(ranks) -> dict:
    """(e) on one rank: DeepFM at its published config, the tables'
    rows over the 4 ranks of (1, 4), m and v by ZeRO-1 (`_opt_specs`),
    one step on its quarter of train_batch; the rows the batch updates
    here and a sample of the rest, after the step."""
    from repro_torch import tree as TT
    from repro_torch.configs.registry import _opt_specs, deepfm_train_step
    from repro_torch.core import specs as S
    from repro_torch.models.recsys import deepfm as D
    from repro_torch.optim.adamw import adamw_init

    dev, world, r = ranks.device, ranks.world_size, ranks.rank
    cfg = arch_config("deepfm")
    specs = D.param_specs(cfg)
    torch.cuda.reset_peak_memory_stats()
    full = D.init_params(torch.Generator(device=dev).manual_seed(DEEPFM_SEED),
                         cfg)
    params = {k: (v.clone() if k in ("table", "fm_w") else v)
              for k, v in D.shard_params(full, ranks, cfg).items()}
    del full
    torch.cuda.empty_cache()
    state = adamw_init(params, specs, ranks)
    whole = D.init_params(None, cfg, device="meta")
    mv = _opt_specs(specs, whole, ranks.axis_size("data"))["m"]
    m_want = [S.local_shape(x.shape, s, ranks) for x, s in zip(
        TT.leaves(whole), S.spec_leaves(mv, whole))]
    m_local = [tuple(x.shape) for x in TT.leaves(state["m"])]
    check(m_local == m_want, f"deepfm rank {r}: m {m_local}, _opt_specs "
          f"{m_want}")
    batch = deepfm_train_batch()
    b = batch["ids"].shape[0] // world
    mine = {k: torch.from_numpy(v[r * b:(r + 1) * b]).to(dev)
            for k, v in batch.items()}
    step = deepfm_train_step(cfg, train_opt(), ranks=ranks)
    counted = CollectiveBytes()
    new, _, m, ms = timed_step(step, params, state, mine, counted)
    rows = params["table"].shape[0]
    flat = D._flat_ids(torch.from_numpy(batch["ids"]), cfg).long()
    hit = torch.unique(flat[(flat >= r * rows) & (flat < (r + 1) * rows)])
    other = torch.randint(0, rows, (DEEPFM_TRAIN_SAMPLE,),
                          generator=torch.Generator().manual_seed(r)) + r * rows
    keep = torch.cat([hit, other]).to(dev)
    rec = {"rows": keep.cpu(), "hit_rows": hit.numel(),
           "table": new["table"][keep - r * rows].cpu(),
           "fm_w": new["fm_w"][keep - r * rows].cpu(),
           "mlp": [x.cpu() for x in TT.leaves(new["mlp"])],
           "grad_norm": m["grad_norm"], "step_ms": round(ms, 3),
           "table_rows_per_rank": rows, "m_local": m_local,
           "collective_bytes": counted.bytes, "remote_bytes": counted.remote,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    del params, new, state
    torch.cuda.empty_cache()
    log(f"rank {r} deepfm train step: "
        f"{ {k: v for k, v in rec.items() if not isinstance(v, (torch.Tensor, list))} }")
    return rec


def deepfm_train_reference(dev, recs: list) -> dict:
    """(e)'s reference: the one-process step on the card on the whole
    batch; every rank's rows and the dense weights against it."""
    from repro_torch import tree as TT
    from repro_torch.configs.registry import deepfm_train_step
    from repro_torch.models.recsys import deepfm as D
    from repro_torch.optim.adamw import adamw_init

    cfg = arch_config("deepfm")
    params = D.init_params(torch.Generator(device=dev)
                           .manual_seed(DEEPFM_SEED), cfg)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in deepfm_train_batch().items()}
    new, _, m, ms = timed_step(deepfm_train_step(cfg, train_opt()), params,
                               adamw_init(params), batch)
    worst = {"table": 0.0, "fm_w": 0.0, "mlp": 0.0}
    for rec in recs:
        got = rec["deepfm"]
        keep = got["rows"].to(dev)
        pairs = [(name, got[name], new[name][keep])
                 for name in ("table", "fm_w")] + [
            ("mlp", a, w) for a, w in zip(got["mlp"], TT.leaves(new["mlp"]))]
        for name, a, w in pairs:
            worst[name] = max(worst[name], float_err(
                a.to(dev), w, 0.0, DEEPFM_TRAIN_ATOL))
        err = abs(got["grad_norm"] - m["grad_norm"]) / m["grad_norm"]
        check(err <= DEEPFM_TRAIN_GNORM_RTOL, f"deepfm rank {rec['rank']}: "
              f"grad_norm {got['grad_norm']} vs {m['grad_norm']}")
    out = {"one_card_step_ms": round(ms, 3), "max_abs_err": worst,
           "grad_norm_rel_err": err,
           "rows_held": sum(rec["deepfm"]["rows"].numel() for rec in recs),
           "hit_rows": sum(rec["deepfm"]["hit_rows"] for rec in recs)}
    del params, new
    torch.cuda.empty_cache()
    log(f"train (e) deepfm across ranks vs one card: {out}")
    return out


def train_rank_prog(ranks, nccl: bool, seq: int, ckpt_dir: str) -> dict:
    """Phase 14 on one rank: (a)-(e) in turn; with `nccl`, (b) alone."""
    out, walls = {"rank": ranks.rank}, {}
    parts = [("gemma", lambda: gemma_rank_runs(ranks, seq, ckpt_dir, nccl))]
    if not nccl:
        parts = [("mesh_lm", lambda: mesh_lm_rank_runs(ranks)), *parts,
                 ("qwen", lambda: qwen_rank_runs(ranks)),
                 ("gnn", lambda: gnn_train_rank_runs(ranks)),
                 ("deepfm", lambda: deepfm_train_rank_runs(ranks))]
    for name, run in parts:
        t = time.perf_counter()
        out[name] = run()
        walls[name] = round(time.perf_counter() - t, 1)
    out["wall_s"] = walls
    return out


def train_ranks_phase(dev, nccl: bool = False) -> dict:
    """Phase 14: training across ranks. One card: 4 ranks sharing it over
    gloo, spawned once, every part's meshes built on the one group
    (`RankContext.remesh`); `nccl`: one NCCL rank a card on a host of 4,
    gemma3-1b at train_4k's sequence. The one-process references run in
    this process after the ranks are gone."""
    import tempfile

    t0 = time.perf_counter()
    world = torch.cuda.device_count() if nccl else TRANKS
    check(world == TRANKS, f"phase 14 needs {TRANKS} ranks, not {world}")
    seq = GEMMA_X_NCCL_SEQ if nccl else GEMMA_X_SEQ
    out = {"world": world, "backend": "nccl" if nccl else "gloo",
           "gemma_seq": seq}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=checkpoint_root()) as ckpt:
        recs = spawn_ranks(world, "train_rank_prog", nccl, seq, ckpt,
                           device=None if nccl else str(dev),
                           backend=None if nccl else "gloo",
                           axis_sizes=(1, world), axis_names=TRAIN_AXES)
        out["ranks_wall_s"] = round(time.perf_counter() - t0, 1)
        out["gemma"] = gemma_reference(dev, recs, seq, ckpt, nccl)
    if not nccl:
        out["mesh_lm"] = mesh_lm_reference(dev, recs)
        out["qwen"] = qwen_reference(dev, recs)
        out["gnn"] = gnn_train_reference(dev, recs)
        out["deepfm"] = deepfm_train_reference(dev, recs)
        out["segment_reduce_launches"] = sum(r["gnn"]["launches"]
                                             for r in recs)
        check(out["segment_reduce_launches"] > 0,
              "phase 14: segment_reduce was not launched")
        for rec in recs:
            rec.pop("mesh_lm")
            for arch in ("meshgraphnet", "graphcast"):
                rec["gnn"][arch].pop("params")
            for k in ("rows", "table", "fm_w", "mlp"):
                rec["deepfm"].pop(k)
    out["ranks"] = recs
    out["seconds"] = round(time.perf_counter() - t0, 1)
    log(f"phase 14 (training across {world} ranks, {out['backend']}): "
        f"{out['seconds']} s; segment_reduce launched "
        f"{out.get('segment_reduce_launches', 0)} times on the ranks")
    return out


# -- main ----------------------------------------------------------------------



# -- phase 15: the cells (build_cell) and the dry-run ---------------------------

CELL_SEED = 23
CELL_REPEATS = 5
DRYRUN_FAMILY_CELLS = [("gemma3-1b", "train_4k"), ("graphcast", "ogb_products"),
                       ("deepfm", "serve_bulk"), ("mapsq", "join_16m")]
COUNT_CELLS = [("gat-cora", "full_graph_sm", None),
               ("deepfm", "serve_p99", None),
               ("gemma3-1b", "train_4k", 1),  # batch cut to 1 x 4096
               ("mapsq", "join_1m", None)]


def start_dryrun(cells, out: pathlib.Path, all_cells: bool = False):
    """`python -m repro_torch.launch.dryrun` over `cells` on both meshes
    (every cell with `all_cells`), in a process of its own (one fake
    process group a process); returns (process, out dir, start time)."""
    out.mkdir(parents=True, exist_ok=True)
    for f in out.glob("*.json*"):
        f.unlink()
    if all_cells:
        code = ("import sys\nfrom repro_torch.launch import dryrun\n"
                f"sys.exit(dryrun.main(['--all', '--out', {str(out)!r}]))\n")
    else:
        code = ("import sys\nfrom repro_torch.launch import dryrun\n"
                f"for a, s in {cells!r}:\n"
                "    if dryrun.main(['--arch', a, '--shape', s, '--mesh', "
                f"'both', '--out', {str(out)!r}]):\n"
                "        sys.exit(1)\n")
    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, out, time.perf_counter()


def finish_dryrun(started, timeout: float) -> tuple[dict, float]:
    """The records of a `start_dryrun` process, keyed "arch/shape/mesh",
    and its wall seconds; fails on its failure or a cell's .err."""
    proc, out, t0 = started
    try:
        text, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"the dry-run took over {timeout} s")
    wall = time.perf_counter() - t0
    errs = sorted(p.name for p in out.glob("*.err"))
    check(proc.returncode == 0 and not errs,
          f"dry-run failed (rc {proc.returncode}, {errs}):\n{text[-4000:]}")
    recs = {}
    for p in sorted(out.glob("*.json")):
        a, sh, mesh = p.stem.split("__")
        recs[f"{a}/{sh}/{mesh}"] = json.loads(p.read_text())
    return recs, wall


def record_terms(rec: dict) -> dict:
    """A dry-run record's roofline terms, memory and bottleneck."""
    mem = rec["memory"]
    return {"t_compute_s": rec["t_compute"], "t_memory_s": rec["t_memory"],
            "t_collective_s": rec["t_collective"],
            "bottleneck": rec["bottleneck"],
            "flops_per_device": rec["flops_per_device"],
            "collective_bytes": rec["collective_bytes_per_device"]["total"],
            "hbm_gib": round((mem["temp_bytes"] + mem["argument_bytes"])
                             / 2**30, 3),
            "fits_hbm": rec["fits_hbm"], "t_trace_s": rec["t_trace_s"],
            "kernel_calls": rec["kernel_calls"]}


def join_oracle(left, right) -> tuple[int, torch.Tensor]:
    """The join's size from a NumPy count (per key, left rows times right
    rows) and its (x, y, z) rows from plain torch on the card (sort by
    the key, expand every pair), independent of the port's join."""
    import numpy as np

    ly, ry = left[:, 1], right[:, 0]
    n = int(max(int(ly.max()), int(ry.max())) + 1)
    cl = np.bincount(ly.cpu().numpy(), minlength=n).astype(np.int64)
    cr = np.bincount(ry.cpu().numpy(), minlength=n).astype(np.int64)
    count = int((cl * cr).sum())
    lo = torch.argsort(ly, stable=True)
    ro = torch.argsort(ry, stable=True)
    ls, rs = left[lo], right[ro]
    ccr = torch.bincount(ry, minlength=n)
    start = torch.cumsum(ccr, 0) - ccr
    reps = ccr[ls[:, 1].long()]
    li = torch.repeat_interleave(torch.arange(ls.shape[0], device=left.device),
                                 reps)
    first = torch.cumsum(reps, 0) - reps
    k = torch.arange(li.shape[0], device=left.device) - first[li]
    ri = start[ls[li, 1].long()] + k
    rows = torch.stack([ls[li, 0], ls[li, 1], rs[ri, 1]], 1)
    return count, rows


def sorted_rows(rows: torch.Tensor) -> torch.Tensor:
    """Rows (n, 3) in lexicographic order (three stable sorts)."""
    for c in (2, 1, 0):
        rows = rows[torch.argsort(rows[:, c], stable=True)]
    return rows


def within_multiset(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Whether every row of `got` is a row of `want`, as often or less."""
    _, inv = torch.unique(torch.cat([want, got]), dim=0, return_inverse=True)
    n = int(inv.max()) + 1 if inv.numel() else 0
    cw = torch.bincount(inv[:want.shape[0]], minlength=n)
    cg = torch.bincount(inv[want.shape[0]:], minlength=n)
    return bool((cg <= cw).all())


def mapsq_cell_run(dev, shape: str, multi: bool) -> dict:
    """(a) One mapsq cell for real: every shard of the production mesh a
    local shard of one ShardMesh on the card, the cell's seeded relations
    at full row counts, the cell's own step at its capacities; held to
    the oracle. On 2 x 16 x 16 the reference's capacities overflow the
    pod stage (one bucket sized by the largest axis, ROADMAP Queue 3):
    there the flag and the rows lost are logged, and the rows the join
    produced are held to be the oracle's (a sub-multiset)."""
    from repro_torch import kernels
    from repro_torch.configs import registry as R
    from repro_torch.core.distributed import make_mesh

    sizes = (2, 16, 16) if multi else (16, 16)
    names = ("pod", "data", "model") if multi else ("data", "model")
    cell = R.build_cell("mapsq", shape, make_mesh(sizes, names), multi)
    left, right = cell.materialize(CELL_SEED, dev)
    in_bytes = tree_bytes([left.cols, left.valid, right.cols, right.valid])
    rec = {"rows": int(left.cols.shape[0]), "shards": math.prod(sizes),
           "note": cell.note}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clear_launches(kernels)
    out, total, ov = cell.fn(left, right)
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["pair_expand"]
    check(launches == 1, f"mapsq {shape}: pair_expand launched {launches} "
          "times in one join (the stacked form: once)")
    overflowed = bool(ov.any())
    check(multi or not overflowed, f"mapsq {shape}: a stage overflowed")
    count, want = join_oracle(left.cols, right.cols)
    got = out.cols[out.valid]
    if overflowed:
        check(within_multiset(got, want), f"mapsq {shape}: rows that are "
              "not the oracle's")
    else:
        check(int(total.sum()) == count,
              f"mapsq {shape}: {int(total.sum())} rows, the oracle {count}")
        check(got.shape[0] == count and torch.equal(sorted_rows(got),
                                                    sorted_rows(want)),
              f"mapsq {shape}: rows differ from the oracle's as a multiset")
    peak = torch.cuda.max_memory_allocated()
    produced = int(got.shape[0])
    del want, got
    ms = sorted(time_steps(lambda: cell.fn(left, right), CELL_REPEATS))
    work = card_work(device_breakdown(lambda: cell.fn(left, right), 2))
    rec.update({"result_rows": count, "rows_produced": produced,
                "rows_lost": count - produced, "overflow": overflowed,
                "input_bytes": in_bytes, "peak_bytes": peak, "warm_ms": ms,
                "warm_p50_ms": ms[len(ms) // 2], "device_launches": work[0],
                "card_busy_ms": work[1],
                "pair_expand_launches_per_call": launches})
    log(f"cells mapsq {shape} {'x'.join(map(str, sizes))}: {produced} of "
        f"the oracle's {count} rows (overflow {overflowed}), p50 "
        f"{rec['warm_p50_ms']:.3f} ms, peak {peak / 1e9:.3f} GB, "
        f"{work[0]} launches")
    return rec


def counted_cell(dev, arch: str, shape: str, batch) -> dict:
    """(c) One cell on a one-rank mesh: the meta trace's FLOPs and
    argument bytes against one step on real tensors on the card."""
    from repro_torch import kernels
    from repro_torch.configs import registry as R
    from repro_torch.core.distributed import make_mesh
    from repro_torch.launch.dryrun import count_step
    from repro_torch.obs.costs import nbytes

    mesh = make_mesh((1, 1), ("data", "model"))
    if batch is None:
        cell = R.build_cell(arch, shape, mesh, False)
    else:
        mod = R.importlib.import_module(R.ARCHS[arch])
        sh = dict(R.SHAPES_FOR(arch)[shape], batch=batch)
        cell = R._build_lm(arch, mod.CONFIG, shape, sh, mesh, False)
    meta_args = cell.local()
    meta = count_step(cell.fn, meta_args)
    args = cell.materialize(CELL_SEED, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    clear_launches(kernels)
    card = count_step(cell.fn, args, memory=False)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = dict(kernels.LAUNCHES)
    check(card["flops"] == meta["flops"],
          f"{arch} {shape}: {card['flops']} FLOPs on the card, the meta "
          f"trace {meta['flops']}")
    check(nbytes(args) == nbytes(meta_args),
          f"{arch} {shape}: argument bytes differ from the meta trace's")
    check(card["kernels"] == meta["kernels"],
          f"{arch} {shape}: kernel calls {card['kernels']} on the card, "
          f"{meta['kernels']} traced")
    predicted = meta["temp_bytes"] + nbytes(meta_args)
    rec = {"flops": card["flops"], "argument_bytes": nbytes(args),
           "bytes_traced": meta["bytes"], "bytes_card": card["bytes"],
           "temp_bytes_traced": meta["temp_bytes"],
           "max_memory_allocated": peak, "memory_before_step": base,
           "peak_over_trace": round(peak / predicted, 4) if predicted else None,
           "kernel_calls": card["kernels"], "kernel_launches": launches}
    log(f"cells {arch} {shape}: {card['flops']:.4g} FLOPs card == meta, "
        f"peak {peak / 1e9:.3f} GB against the trace's {predicted / 1e9:.3f}")
    del args, card
    torch.cuda.empty_cache()
    return rec


def cells_phase(dev, dryrun_all: bool = False) -> dict:
    """Phase 15: (b) the dry-run of one cell a family on both meshes (a
    CPU process, started first), (a) the mapsq cells for real on the
    card, (c) the FLOP and argument-byte counts of four cells held on the
    card to the meta trace; with `dryrun_all` the dry-run of every cell."""
    t0 = time.perf_counter()
    out_dir = ROOT / "build" / "dryrun"
    started = start_dryrun(DRYRUN_FAMILY_CELLS, out_dir, dryrun_all)
    try:
        joins = {f"{s}/{'multi' if m else 'single'}": mapsq_cell_run(dev, s, m)
                 for s, m in (("join_1m", False), ("join_16m", False),
                              ("join_1m", True))}
        counts = {f"{a}/{s}": counted_cell(dev, a, s, b)
                  for a, s, b in COUNT_CELLS}
    finally:  # a failed check ends the run: stop the dry-run with it
        if started[0].poll() is None and sys.exc_info()[0] is not None:
            started[0].kill()
            started[0].communicate()
    recs, wall = finish_dryrun(started, 900 if dryrun_all else 240)
    want = {f"{a}/{s}/{m}" for a, s in DRYRUN_FAMILY_CELLS
            for m in ("single", "multi")}
    check(want <= set(recs), f"dry-run records missing: "
          f"{sorted(want - set(recs))}")
    terms = {k: record_terms(r) for k, r in recs.items()}
    for k in sorted(terms if dryrun_all else want):
        t = terms[k]
        log(f"dryrun {k}: compute {t['t_compute_s']:.4g} s, memory "
            f"{t['t_memory_s']:.4g} s, collective {t['t_collective_s']:.4g} "
            f"s -> {t['bottleneck']}; {t['hbm_gib']} GiB a card")
    reached: dict[str, list] = {}
    for k, t in terms.items():
        for name in t["kernel_calls"]:
            reached.setdefault(name, []).append(k)
    for k, c in counts.items():
        for name in c["kernel_calls"]:
            reached.setdefault(name, []).append(k + "/one-rank")
    out = {"mapsq": joins, "counts": counts,
           "dryrun": terms if dryrun_all else {k: terms[k] for k in want},
           "dryrun_wall_s": round(wall, 1), "kernel_cells": reached,
           "seconds": round(time.perf_counter() - t0, 1)}
    log(f"cells phase: {out['seconds']} s (dry-run {wall:.1f} s)")
    return out


# -- phase 16: the engine's and server's modes ----------------------------------

MODES_WARM = 10  # warm repeats of a J query on each planner, (a)
# (c): requests a burst, each server; Q9's decode is ~0.5 s a request
MODES_BURSTS = {"Q1": 8, "Q2": 8, "Q4": 8, "Q7": 8, "S1": 8, "Q9": 2}


def pair_expand_launches(kernels, fn):
    """`fn()` with the launch counts set to 0 just before it: its result
    and pair_expand's launches in it."""
    clear_launches(kernels)
    out = fn()
    return out, kernels.LAUNCHES.get("pair_expand", 0)


def event_ms(fn) -> tuple:
    """`fn()` between two CUDA events: its result and their ms."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def j_shapes_part(dev, store, kernels) -> dict:
    """(a) J1/J2 on the greedy planner and on the optimizer."""
    import numpy as np

    from repro_torch.sparql import lubm
    from repro_torch.sparql.baseline import reference_rows
    from repro_torch.sparql.engine import QueryEngine
    from repro_torch.sparql.parser import parse
    from repro_torch.sparql.store import TripleStore

    engines = {"greedy": QueryEngine(store, device=dev, optimize=False),
               "optimized": QueryEngine(store, device=dev)}
    out = {}
    for name, text in lubm.J_QUERIES.items():
        q = parse(text)
        # every pattern's predicate is a constant: the oracle over the
        # triples that carry one of them is the oracle over the store
        pids = [store.dictionary.lookup(tp.p) for tp in q.patterns]
        sub = store.triples[np.isin(store.triples[:, 1], pids)]
        oracle = row_multiset(
            reference_rows(TripleStore(sub, store.dictionary), q))
        rec = {}
        for label, eng in engines.items():
            pq = eng.prepare(text)
            backends = pq._program.plan.join_backends
            if label == "greedy":
                check(set(backends) == {"mr"} and not pq._program.plan.prune,
                      f"{name}: the greedy plan is not the legacy one")
            cold, cold_pe = pair_expand_launches(kernels, pq.run)
            lat = []
            clear_launches(kernels)
            for _ in range(MODES_WARM):
                warm, ms = event_ms(pq.run)
                lat.append(ms)
                check(warm.stats.n_dispatches == 1
                      and warm.stats.n_compiles == 0,
                      f"{name} [{label}] warm: {warm.stats}")
            warm_pe = kernels.LAUNCHES.get("pair_expand", 0)
            joins = sum(b == "mr" for b in backends) - sum(
                pq._program.cross_flags)
            check(warm_pe == joins * MODES_WARM, f"{name} [{label}]: "
                  f"{warm_pe} pair_expand launches in {MODES_WARM} warm "
                  f"runs of {joins} MR joins")
            check(row_multiset(cold.rows) == oracle
                  and row_multiset(warm.rows) == oracle,
                  f"{name} [{label}]: rows != reference_rows")
            check(cold.stats.peak_join_bucket <= eng.max_capacity,
                  f"{name} [{label}]: bucket past max_capacity")
            rec[label] = {
                "rows": len(warm.rows), "backends": list(backends),
                "peak_join_bucket": cold.stats.peak_join_bucket,
                "warm_p50_ms": statistics.median(lat),
                "pair_expand_cold": cold_pe,
                "pair_expand_warm_run": warm_pe // MODES_WARM,
                "pair_expand": cold_pe + warm_pe,
            }
        g, o = rec["greedy"], rec["optimized"]
        check(o["peak_join_bucket"] < g["peak_join_bucket"],
              f"{name}: optimized bucket {o['peak_join_bucket']} not below "
              f"greedy's {g['peak_join_bucket']}")
        log(f"  modes (a) {name}: {rec}")
        out[name] = rec
    return out


def overflow_part(dev, store, texts, card_rows, kernels) -> dict:
    """(b) the eager engine with double-on-overflow sizing: at full scale
    against the default engine's rows, at scale 2 against the CPU port."""
    from repro_torch.sparql import lubm
    from repro_torch.sparql.engine import QueryEngine
    from repro_torch.sparql.store import TripleStore

    def mode_engine(s, device, **kw):
        return QueryEngine(s, device=device, compiled=False,
                           exact_count_pass=False, **kw)

    eng = mode_engine(store, dev)
    out = {}
    for name in card_rows:
        pq = eng.prepare(texts[name])
        prog = pq._program
        check(not prog.opt_groups and not prog.union_groups,
              f"{name}: not a BGP")
        t = time.perf_counter()
        res, launched = pair_expand_launches(kernels, pq.run)
        secs = time.perf_counter() - t
        st = res.stats
        # every dispatch of a BGP's double-on-overflow joins is one MR
        # join attempt but for the cross joins
        attempts = st.n_dispatches - sum(prog.cross_flags)
        check(row_multiset(res.rows) == row_multiset(card_rows[name]),
              f"{name}: double-on-overflow rows != default engine's")
        check(st.n_count_passes == 0, f"{name}: a count pass ran")
        check(launched == attempts, f"{name}: {launched} pair_expand "
              f"launches for {attempts} MR join attempts")
        out[name] = {"rows": len(res.rows), "n_retries": st.n_retries,
                     "n_dispatches": st.n_dispatches,
                     "peak_join_bucket": st.peak_join_bucket,
                     "pair_expand": launched, "s": secs}
        log(f"  modes (b) {name}: {out[name]}")

    small = lubm.generate(scale=SMALL_SCALE, join_shapes=True,
                          skew_shapes=True)
    terms = [small.dictionary.decode(i) for i in range(len(small.dictionary))]
    pair = {d: mode_engine(TripleStore.from_arrays(small.triples, terms), d)
            for d in (dev, "cpu")}
    retries = {}
    for name in card_rows:
        res, launched = pair_expand_launches(
            kernels, pair[dev].prepare(texts[name]).run)
        cpu = pair["cpu"].prepare(texts[name]).run()
        for f in ("n_retries", "n_dispatches", "n_count_passes",
                  "peak_join_bucket"):
            check(getattr(res.stats, f) == getattr(cpu.stats, f),
                  f"{name} scale {SMALL_SCALE}: {f} card "
                  f"{getattr(res.stats, f)} != cpu {getattr(cpu.stats, f)}")
        check(res.rows == cpu.rows, f"{name} scale {SMALL_SCALE}: rows")
        retries[name] = (res.stats.n_retries, res.stats.peak_join_bucket)
        out[name]["pair_expand"] += launched
    name = max(retries, key=lambda k: retries[k][0])
    check(retries[name][0] > 0, f"no retry at scale {SMALL_SCALE}: {retries}")
    # a join that overflows doubles past a max_capacity of 1 and raises,
    # on the card and on the CPU
    for d in (dev, "cpu"):
        cut = mode_engine(TripleStore.from_arrays(small.triples, terms), d,
                          max_capacity=1)
        raised = False
        try:
            cut.prepare(texts[name]).run()
        except MemoryError:
            raised = True
        check(raised, f"{name} [{d}]: no MemoryError past max_capacity 1")
    log(f"  modes (b) scale {SMALL_SCALE}: (retries, bucket) card == cpu "
        f"{retries}; MemoryError past max_capacity 1 on {name}")
    return {"full": out, "small_retries": retries}


def servers_part(dev, store, texts, card_rows, kernels) -> dict:
    """(c) one engine behind the default, the synchronous and the unbatched
    server, in turn; two rounds of bursts each, round 2 timed."""
    from repro_torch.serve.sparql_server import SPARQLServer
    from repro_torch.sparql.engine import QueryEngine

    engine = QueryEngine(store, device=dev)
    for name in MODES_BURSTS:  # cold runs (calibration, compile) first
        engine.prepare(texts[name]).run()
    out = {}
    for label, kw in (("default", {}), ("sync", {"decode_workers": 0}),
                      ("unbatched", {"batch_execution": False})):
        srv = SPARQLServer(engine, max_batch=16, max_wait_s=0.02, **kw)
        try:
            dispatched = engine.stacked_dispatches
            clear_launches(kernels)
            lat = []
            for rnd in (1, 2):
                for name, n in MODES_BURSTS.items():
                    got = burst(srv, texts[name], n, card_rows[name],
                                card_rows[name])
                    if rnd == 2:
                        lat += got
            launched = kernels.LAUNCHES.get("pair_expand", 0)
            decode = srv.stats()["pipeline"]["decode"]
        finally:
            srv.close()
        stacked = engine.stacked_dispatches - dispatched
        lat.sort()
        out[label] = {
            "requests": len(lat), "p50_ms": statistics.median(lat) * 1e3,
            "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3,
            "stacked_dispatches": stacked, "pair_expand": launched,
            "decode_pool": decode is not None,
        }
        log(f"  modes (c) {label} server: {out[label]}")
    check(out["default"]["stacked_dispatches"] > 0
          and out["default"]["decode_pool"], "the default server did not "
          "stack or has no decode pool")
    check(out["unbatched"]["stacked_dispatches"] == 0,
          "the unbatched server stacked a dispatch")
    check(not out["sync"]["decode_pool"], "the synchronous server has a "
          "decode pool")
    return out


def modes_inputs(dev) -> dict:
    """What phase 16 takes from phase 5 when run alone: the full-scale
    store, the texts and the default engine's rows on the card."""
    from repro_torch.sparql import lubm
    from repro_torch.sparql.engine import QueryEngine

    t = time.perf_counter()
    store = lubm.generate(scale=FULL_SCALE, join_shapes=True, skew_shapes=True)
    log(f"modes inputs: LUBM scale {FULL_SCALE}, {len(store)} triples, "
        f"generated in {time.perf_counter() - t:.1f} s (host)")
    texts = {**lubm.QUERIES, **lubm.S_QUERIES}
    engine = QueryEngine(store, device=dev)
    rows = {name: engine.query(text) for name, text in texts.items()}
    return {"store": store, "texts": texts, "card_rows": rows}


def modes_phase(dev, full: dict) -> dict:
    """Phase 16: the legacy planner, double-on-overflow sizing and the
    synchronous and unbatched servers on phase 5's store."""
    from repro_torch import kernels

    t0 = time.perf_counter()
    store, texts, card_rows = full["store"], full["texts"], full["card_rows"]
    j = j_shapes_part(dev, store, kernels)
    over = overflow_part(dev, store, texts, card_rows, kernels)
    servers = servers_part(dev, store, texts, card_rows, kernels)
    launches = (sum(r["pair_expand"] for q in j.values() for r in q.values())
                + sum(r["pair_expand"] for r in over["full"].values())
                + sum(r["pair_expand"] for r in servers.values()))
    out = {"j_shapes": j, "double_on_overflow": over, "servers": servers,
           "pair_expand_launches": launches,
           "seconds": round(time.perf_counter() - t0, 1)}
    log(f"phase 16 (the engine's modes): {out['seconds']} s; pair_expand "
        f"launched {launches} times")
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1-2 only: build, check and time the "
                    "kernels; prints the kernels line and no result line")
    ap.add_argument("--src", type=pathlib.Path, default=ROOT / "src",
                    help="the tree whose repro_torch to drive (default: "
                    "this checkout's src/); with --kernels-only, times an "
                    "earlier commit's kernels in the same call")
    ap.add_argument("--lm-only", action="store_true",
                    help="phase 10 (LM serving) alone; no result line")
    ap.add_argument("--gnn-only", action="store_true",
                    help="the build and phase 11 (GNN and recsys forward) "
                    "alone; no result line")
    ap.add_argument("--train-only", action="store_true",
                    help="the build and phase 12 (training) alone; no "
                    "result line")
    ap.add_argument("--exchanges-only", action="store_true",
                    help="the build and phase 13 (model exchanges across "
                    "4 gloo ranks on one card) alone; no result line")
    ap.add_argument("--exchanges-nccl", action="store_true",
                    help="the build and phase 13 with one NCCL rank a card "
                    "(several cards), MeshGraphNet at ogb_products' dims; "
                    "no result line")
    ap.add_argument("--train-ranks-only", action="store_true",
                    help="the build and phase 14 (training across 4 gloo "
                    "ranks on one card) alone; no result line")
    ap.add_argument("--train-ranks-nccl", action="store_true",
                    help="the build and phase 14's gemma3-1b part with one "
                    "NCCL rank a card (4 cards) at train_4k's sequence; no "
                    "result line")
    ap.add_argument("--nccl-only", action="store_true",
                    help="phase 9's NCCL run alone (on a host of several "
                    "cards: one rank per card at scale 1000) with the "
                    "one-process runs it is held to; no result line")
    ap.add_argument("--cells-only", action="store_true",
                    help="the build and phase 15 (the cells and the "
                    "dry-run) alone; no result line")
    ap.add_argument("--dryrun-all", action="store_true",
                    help="with --cells-only: the dry-run of every cell on "
                    "both meshes (84 records) instead of one a family")
    ap.add_argument("--modes-only", action="store_true",
                    help="the build and phase 16 (the engine's and "
                    "server's modes) alone, on a store of its own; no "
                    "result line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        fail("no CUDA device")
    src = args.src.resolve()
    if not (src / "repro_torch").is_dir():
        fail(f"the port's package is missing under {src}")
    if src != (ROOT / "src").resolve():
        if not args.kernels_only:
            fail("--src names another tree: only with --kernels-only")
        global STRICT
        STRICT = False
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
    if args.lm_only:
        out = lm_phase(dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"lm": out}), flush=True)
        print(card, flush=True)
        return 0
    t = time.perf_counter()
    kernels.build_all()
    log(f"build: {len(kernels.all_sources())} kernel sources in "
        f"{time.perf_counter() - t:.2f} s")

    log(f"tree: {src}")
    if args.gnn_only:
        out = gnn_phase(dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"gnn": out}), flush=True)
        print(card, flush=True)
        return 0
    if args.train_only:
        out = train_phase(dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"train": out}), flush=True)
        print(card, flush=True)
        return 0
    if args.exchanges_only or args.exchanges_nccl:
        out = exchange_phase(dev, nccl=args.exchanges_nccl)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"exchanges": out}, default=str), flush=True)
        print(card, flush=True)
        return 0
    if args.train_ranks_only or args.train_ranks_nccl:
        out = train_ranks_phase(dev, nccl=args.train_ranks_nccl)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"train_ranks": out}, default=str), flush=True)
        print(card, flush=True)
        return 0
    if args.cells_only:
        out = cells_phase(dev, dryrun_all=args.dryrun_all)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"cells": out}, default=str), flush=True)
        print(card, flush=True)
        return 0
    if args.modes_only:
        out = modes_phase(dev, modes_inputs(dev))
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"modes": out}, default=str), flush=True)
        print(card, flush=True)
        return 0
    if args.nccl_only:
        out = nccl_only(dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps(out), flush=True)
        print(card, flush=True)
        return 0
    rows = kernel_phase(dev)
    if args.kernels_only:
        print(json.dumps({"kernels": list(rows.values())}), flush=True)
        print(card, flush=True)
        return 0
    stacked = stacked_phase(dev)
    api_launches = kernel_api_phase(dev)
    small_scale_phase(dev)
    full = full_scale_phase(dev)
    matrix = matrix_phase(dev, full)
    serving = serving_phase(dev, full)
    sharded_small_phase(dev)
    sharded = sharded_phase(dev, full)
    ranks = ranks_phase(dev, full, sharded)
    lm = lm_phase(dev)
    gnn = gnn_phase(dev)
    train = train_phase(dev)
    exchanges = exchange_phase(dev)
    train_ranks = train_ranks_phase(dev)
    cells = cells_phase(dev)
    modes = modes_phase(dev, full)
    for name, row in rows.items():
        row["launches"] = (full["launches"] | api_launches).get(name, 0)
        check(row["launches"] > 0, f"kernel {name} was not launched")
    seg = rows["segment_reduce"]
    seg["launches_by_path"] = {
        "kernel_api": seg["launches"],
        "gnn_recsys_forward": gnn["segment_reduce_launches"],
        "gnn_recsys_train": train["segment_reduce_launches"],
        "model_exchanges": exchanges["segment_reduce_launches"],
        "training_across_ranks": train_ranks["segment_reduce_launches"]}
    seg["launches"] += (gnn["segment_reduce_launches"]
                        + train["segment_reduce_launches"]
                        + exchanges["segment_reduce_launches"]
                        + train_ranks["segment_reduce_launches"])
    pair = rows["pair_expand"]
    pair["launches_by_path"] = {
        "full_scale": pair["launches"],
        "cells_mapsq": sum(j["pair_expand_launches_per_call"]
                           for j in cells["mapsq"].values()),
        "engine_modes": modes["pair_expand_launches"]}
    pair["launches"] += (pair["launches_by_path"]["cells_mapsq"]
                         + pair["launches_by_path"]["engine_modes"])
    for name, row in rows.items():
        row["cells"] = sorted(set(cells["kernel_cells"].get(name, [])))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    full = {k: full[k] for k in ("launches", "peak_bytes", "queries")}
    del sharded["store"]
    print(json.dumps({"full_scale": full, "matrix": matrix,
                      "serving": serving, "sharded": sharded,
                      "ranks": ranks, "lm": lm, "gnn": gnn, "train": train,
                      "exchanges": exchanges, "train_ranks": train_ranks,
                      "cells": cells, "modes": modes},
                     default=str),
          flush=True)
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
    sys.exit(main(sys.argv[1:]))
