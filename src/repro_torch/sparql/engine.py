"""The MapSQ query engine (Figure 1 of the paper) and its prepared-query API.

Coprocessing split, exactly as the paper describes it:
  CPU  — parse, dictionary-encode, optimize (sparql/optimizer.py:
         statistics-driven join order, filter pushdown, projection
         pruning), size capacities, dispatch subqueries (this file,
         host Python);
  GPU    — pattern range-scans feed the MapReduce join (Algorithm 1,
         core/mr_join.py) and the matrix join (core/matrix_join.py), on
         the hand-written CUDA kernels under kernels/.

The public API is layered around prepared queries:

  engine.prepare(text) -> PreparedQuery   parse + validate + plan once
  pq.run()             -> ResultSet       typed rows + the run's ExecStats
  pq.explain()         -> str             algebra tree, physical plan,
                                          bucket capacities, cache state
  engine.query(text)   -> list[dict]      thin wrapper: prepare().run().rows
  engine.run_batch(ps) -> list[ResultSet] micro-batch execution: same-shape
                                          queries coalesce into stacked
                                          (vmapped) device dispatches —
                                          N warm same-shape queries cost
                                          ceil(N / width) dispatches
  engine.update(text)  -> UpdateResult    INSERT DATA / DELETE DATA against
                                          the store's delta blocks; warm
                                          plan shapes survive the write
  engine.stats()       -> dict            plan cache + scan cache + the
                                          store's write-path health

Two execution modes share one planner:

  compiled (default) — plan → plan-cache lookup → ONE device dispatch. The
      whole operator tree (joins, OPTIONAL left joins, FILTER masks,
      projection, DISTINCT, LIMIT/OFFSET) is lowered by core/executor.py
      into a single program, cached by (plan shape, bucket signature) in
      a PlanCache. FILTER constants and LIMIT/OFFSET are
      runtime inputs, so query variants share the executable. A cache miss
      first runs the eager evaluator once: its Mars count passes double as
      the capacity *calibration* that picks the pow-2 join buckets the
      program is compiled at. Warm queries then run with zero compiles and
      no per-join host sync (the only sync reads the overflow flags that
      ride back with the results). If a bucket overflows (a same-shape
      query with a bigger result), the engine grows the bucket from the
      exact totals returned by the dispatch and recompiles — the
      double-on-overflow retry demoted to a host-level fallback.

  eager (compiled=False) — the per-operator loop, kept for differential
      testing: per join, a COUNT pass, host sync of the cardinality,
      exactly-sized (next-pow2) buffer, EXPAND pass; or double-on-overflow
      when exact_count_pass=False.

The engine runs on the card unless it is given device="cpu"; the store
stages its scans on the engine's device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import logging
import pathlib
import threading
import time
from collections import OrderedDict
from typing import TYPE_CHECKING, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import distributed as dj
from repro_torch.core import executor as ex
from repro_torch.core import mr_join as mj
from repro_torch.core import plan_ir
from repro_torch.core.planner import TriplePattern
from repro_torch.core.relation import UNBOUND, Relation
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.sparql import algebra, optimizer
from repro_torch.sparql.parser import Query, UpdateRequest, parse, parse_update
from repro_torch.core.plan_ir import next_pow2
from repro_torch.sparql.store import StoreStatistics, TripleStore

if TYPE_CHECKING:
    from repro_torch.core.ranks import RankContext

log = logging.getLogger(__name__)

# LIMIT stand-in when only OFFSET was given (far above max_capacity, safe
# from int32 overflow in `offset + limit`).
_NO_LIMIT = 1 << 30


@dataclasses.dataclass
class ExecStats:
    n_joins: int = 0
    n_count_passes: int = 0
    n_retries: int = 0
    peak_capacity: int = 0
    peak_join_bucket: int = 0  # largest intermediate join bucket this run
    # compiled-pipeline accounting
    cache_hits: int = 0
    cache_misses: int = 0
    n_compiles: int = 0  # plan programs built by this query
    n_dispatches: int = 0  # device program launches (warm target: 1)
    # stacked-batch accounting: width of the vmapped dispatch that served
    # this run (0 = solo). Batchmates share one dispatch, so their
    # n_dispatches/n_compiles report the chunk's shared counts.
    batch_width: int = 0
    # the store version this run's scans were staged at (-1 = not set):
    # the snapshot the results are consistent with
    store_version: int = -1
    # sharded-execution data movement (zero on the single-device engine):
    # shuffles the lowering emitted vs elided because the input was
    # already hash-partitioned on the join key, and small-side broadcast
    # (all_gather) joins
    n_shuffles_emitted: int = 0
    n_shuffles_elided: int = 0
    n_broadcast_joins: int = 0
    # host seconds from the program's enqueue to the read of its flags,
    # for THIS run (the engine-level `device_time_s` is the sum of these);
    # not the card's time
    device_time_s: float = 0.0
    # rows this run's decode emitted (-1 = not yet decoded)
    rows_emitted: int = -1
    # EXPLAIN ANALYZE actuals, in join-slot (evaluation) order — the same
    # order as plan.join_ests/join_caps. Captured from the exact totals
    # that ride back with every dispatch:
    #   join_totals    global matched rows per join slot
    #   join_worst     worst single shard per slot (fill pressure)
    #   join_overflows overflow->regrow events per slot (summed)
    #   join_caps      bucket capacity the final (successful) run used
    #   shuffle_loads  worst per-shard shuffle rows per shuffle slot
    join_totals: tuple[int, ...] = ()
    join_worst: tuple[int, ...] = ()
    join_overflows: tuple[int, ...] = ()
    join_caps: tuple[int, ...] = ()
    shuffle_loads: tuple[int, ...] = ()

    def add(self, other: "ExecStats") -> None:
        self.n_joins += other.n_joins
        self.n_count_passes += other.n_count_passes
        self.n_retries += other.n_retries
        self.peak_capacity = max(self.peak_capacity, other.peak_capacity)
        self.peak_join_bucket = max(
            self.peak_join_bucket, other.peak_join_bucket
        )
        self.cache_hits += other.cache_hits
        self.cache_misses += other.cache_misses
        self.n_compiles += other.n_compiles
        self.n_dispatches += other.n_dispatches
        self.batch_width = max(self.batch_width, other.batch_width)
        self.store_version = max(self.store_version, other.store_version)
        self.n_shuffles_emitted += other.n_shuffles_emitted
        self.n_shuffles_elided += other.n_shuffles_elided
        self.n_broadcast_joins += other.n_broadcast_joins
        self.device_time_s += other.device_time_s
        if other.rows_emitted >= 0:
            self.rows_emitted = other.rows_emitted
        # actuals: last run wins (pq.stats accumulates across runs but
        # the analyze view reports the most recent execution); overflow
        # events accumulate
        if other.join_totals:
            self.join_totals = other.join_totals
            self.join_worst = other.join_worst
            self.join_caps = other.join_caps
            self.shuffle_loads = other.shuffle_loads
        if other.join_overflows:
            mine = self.join_overflows
            if len(mine) == len(other.join_overflows):
                self.join_overflows = tuple(
                    a + b for a, b in zip(mine, other.join_overflows)
                )
            else:
                self.join_overflows = other.join_overflows


@dataclasses.dataclass
class PlanCacheEntry:
    shape: plan_ir.PlanShape
    join_caps: tuple[int, ...]
    compiled: ex.CompiledPlan
    # (width, per-scan stacked/broadcast axes) -> stacked program at THESE
    # join caps (built on demand by run_batch; reset when an overflow
    # regrow replaces the entry)
    batched: dict[tuple, ex.CompiledBatch] = dataclasses.field(
        default_factory=dict
    )
    # (width, axes) layouts persisted by a previous process (save_cache
    # round-trips them even before this process serves a stacked batch);
    # files that carry widths only load as all-stacked
    warm_layouts: tuple[tuple, ...] = ()

    def widths(self) -> tuple[int, ...]:
        """Known stacked widths for this signature: built this process (at
        any scan layout) plus persisted from the warmup file."""
        return tuple(
            sorted(
                {k[0] for k in self.batched}
                | {w for w, _ in self.warm_layouts}
            )
        )

    def layouts(self) -> tuple[tuple, ...]:
        """Known (width, scan_axes) stacked layouts for this signature."""
        return tuple(
            sorted(
                set(self.batched) | set(self.warm_layouts),
                key=lambda k: (k[0], str(k[1])),
            )
        )


class PlanCache:
    """(plan shape, bucket signature) -> compiled executable, FIFO-bounded."""

    def __init__(self, max_entries: int = 256):
        self.max_entries = max_entries
        self._entries: OrderedDict[plan_ir.PlanShape, PlanCacheEntry] = (
            OrderedDict()
        )
        self.hits = 0
        self.misses = 0
        self.compiles = 0

    def get(self, shape: plan_ir.PlanShape) -> PlanCacheEntry | None:
        return self._entries.get(shape)

    def put(self, shape: plan_ir.PlanShape, entry: PlanCacheEntry) -> None:
        self._entries[shape] = entry
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)

    def __len__(self) -> int:
        return len(self._entries)

    def entries(self) -> list[PlanCacheEntry]:
        return list(self._entries.values())

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "compiles": self.compiles,
            "entries": len(self._entries),
            "hit_rate": self.hit_rate,
        }


@dataclasses.dataclass
class BatchGroupStats:
    """run_batch accounting for one plan group (shared PlanShape).

    `n_dispatches` counts every device dispatch the group made — stacked
    chunks, overflow retries, and the sequential calibration run of a cold
    group — so ceil(N/width) is directly assertable. `widths` lists the
    bucketed lane width of each stacked chunk, in dispatch order."""

    n_queries: int
    widths: tuple[int, ...] = ()
    n_dispatches: int = 0
    n_compiles: int = 0
    cold: bool = False  # group paid calibration/compilation this batch
    # a stacked chunk outgrew max_capacity (MemoryError) and its queries
    # ran one by one so only the culprit fails; any other failure of a
    # stacked dispatch propagates
    fallback: bool = False
    # scan positions shipped ONCE (vmap in_dims None) because every lane's
    # pattern was identical — the same-query-different-FILTER win: those
    # buffers skip the W-copy stacking entirely
    n_broadcast_scans: int = 0
    # cross-shape padding: this group coalesced `n_shapes` near-miss
    # PlanShapes (same plan DAG, smaller pow-2 scan caps) into one stacked
    # signature by padding every lane's scans up to the group's max caps
    padded: bool = False
    n_shapes: int = 1


@dataclasses.dataclass
class _Program:
    """A planned query: scan order, join structure, runtime constants.

    This is the engine-internal bridge from the optimizer's output to a
    PlanShape; a PreparedQuery owns one and reuses it across runs.
    """

    query: Query
    plan: optimizer.OptimizedProgram  # optimizer output incl. trace/ests
    patterns: list[TriplePattern]  # scan order: required, groups, branches
    cross_flags: tuple[bool, ...]  # required chain
    opt_groups: tuple[plan_ir.GroupSpec, ...]
    union_groups: tuple[plan_ir.GroupSpec, ...]
    has_required: bool
    filters: tuple[plan_ir.FilterSpec, ...]  # staged, original var names
    n_consts: tuple[int, int]  # (int, float) filter consts (sans slice)
    consts_i: np.ndarray  # int32: filter term ids (+ offset, limit)
    consts_f: np.ndarray  # float32: numeric filter constants
    projection: tuple[str, ...]
    distinct: bool
    has_slice: bool


@dataclasses.dataclass
class _BatchCtx:
    """Per-query HOST staging for run_batch: the program, its plan-cache
    key and the canonical->original name mapping. Deliberately holds no
    device tensors — scans are re-fetched from the store's bounded caches
    per batch, so a cached PreparedQuery handle never pins device buffers
    past the scan cache's eviction policy. `store_version` records the
    version the shape was computed at: a write can move a pattern into a
    bigger capacity bucket, so a stale ctx is recomputed before grouping."""

    prog: _Program
    shape: plan_ir.PlanShape
    inverse: dict[str, str]
    store_version: int = -1


class _ChunkInputs(NamedTuple):
    """The device inputs of one stacked dispatch (engine._stage_chunk)."""

    scans: tuple[Relation, ...]
    scan_axes: tuple  # per scan: 0 = stacked, None = broadcast
    consts_i: torch.Tensor  # (width, n_i)
    consts_f: torch.Tensor  # (width, n_f)
    num_vals: torch.Tensor  # shared by every lane
    active: torch.Tensor  # (width,) bool: lanes carrying real queries
    store_version: int


class ResultSet:
    """Typed, decoded query result: rows as {var: term} dicts (variables an
    OPTIONAL group left unbound are omitted), plus the producing run's
    ExecStats. Compares equal to a plain list of row dicts for convenience.

    Every row is decoded when the result resolves: the terms come from one
    gather through the dictionary's term table, and only rows an OPTIONAL
    group left partly unbound are built one at a time
    (`QueryEngine._decode_numpy`).
    """

    def __init__(self, vars: tuple[str, ...], rows: list[dict[str, str]],
                 stats: ExecStats):
        self.vars = tuple(vars)
        self.rows = rows
        self.stats = stats

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self):
        return iter(self.rows)

    def __getitem__(self, i):
        return self.rows[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, ResultSet):
            return self.rows == other.rows
        if isinstance(other, list):
            return self.rows == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"ResultSet(vars={self.vars}, n_rows={len(self.rows)})"


class _SharedFetch:
    """One device→host transfer shared by every lane of a stacked chunk
    (or the one result of a solo run).

    The transfer is LAZY: the batcher thread hands lanes to the decode
    pool holding only device references; whichever decode worker resolves
    its lane first pays the (single) sync, and the device buffers are
    dropped immediately after so a slow decode queue never pins a chunk's
    device memory longer than one transfer.

    The fetch may run on another thread than the dispatch, whose current
    stream may differ: a CUDA event recorded on the dispatching thread's
    stream when the result is handed over orders the copy after the
    dispatch's kernels."""

    __slots__ = ("_lock", "_rel", "_ready", "cols", "valid", "transfer_s")

    def __init__(self, rel: Relation):
        self._lock = threading.Lock()
        self._rel: Relation | None = rel
        self._ready = None
        if rel.cols.is_cuda:
            self._ready = torch.cuda.Event()
            self._ready.record(torch.cuda.current_stream(rel.cols.device))
        self.cols: np.ndarray | None = None
        self.valid: np.ndarray | None = None
        self.transfer_s = 0.0

    def fetch(self) -> tuple[np.ndarray, np.ndarray, bool]:
        """Returns (cols, valid, paid): `paid` is True for the one caller
        that performed the device->host sync, False for sharers."""
        with self._lock:
            if self._rel is not None:
                t0 = time.perf_counter()
                if self._ready is not None:
                    dev = self._rel.cols.device
                    torch.cuda.current_stream(dev).wait_event(self._ready)
                self.cols = self._rel.cols.cpu().numpy()
                self.valid = self._rel.valid.cpu().numpy()
                self.transfer_s = time.perf_counter() - t0
                self._rel = None
                return self.cols, self.valid, True
        return self.cols, self.valid, False


def _enqueue(traced: bool, program, *args):
    """`program(*args)`: the enqueue of a plan program's launches, which
    returns before the card runs them. When `traced`, also (its end
    stamp, the seconds of `time.thread_time` the calling thread used
    inside it); else None, and no clock is read."""
    if not traced:
        return program(*args), None
    c0 = time.thread_time()
    out = program(*args)
    c1 = time.thread_time()
    return out, (time.perf_counter(), c1 - c0)


def _add_event(trace, name: str, t0: float, t1: float, enq=None,
               **attrs) -> None:
    """Record a `dispatch` (or `compile`) span on `trace`; with `enq`
    (from `_enqueue`), its `enqueue` child from the same start, with the
    same attributes and `cpu_s`."""
    span = trace.add_span(name, t0, t1, **attrs)
    if enq is not None:
        trace.add_span("enqueue", t0, enq[0], parent=span, cpu_s=enq[1],
                       **attrs)


def _loose_rows(rows: np.ndarray) -> np.ndarray:
    """Per row of an (n, k) id matrix: whether it holds UNBOUND."""
    return (rows == UNBOUND).any(axis=1)


def _dict_rows(schema: tuple[str, ...], terms: np.ndarray) -> list[dict]:
    """(n, k) terms -> n dicts {schema[j]: terms[i, j]}, keys in
    `schema`'s order: the columns' lists zipped into rows, each row into a
    dict, all by `map` in C. No bytecode runs until the list is whole, so
    the collector runs once after it and not every 700 dicts, as it would
    under a loop in Python; each of those young collections would move
    the plan programs then in flight into the old generation, and the
    device memory their reference cycles hold with them."""
    if not schema:
        return [{} for _ in range(len(terms))]
    cols = terms.T.tolist()
    return list(map(dict, map(zip, itertools.repeat(schema), zip(*cols))))


class PendingDecode:
    """A dispatched query's undecoded result: result buffers (device-side
    until the first consumer fetches) plus the lane metadata needed to
    materialise rows.

    This is the unit the serving pipeline passes from the dispatch stage
    to the decode stage — `run_batch_pipelined` returns one per slot, and
    `resolve()` (the transfer + row decode + per-handle accounting) runs
    on a decode worker, overlapping the batcher thread's next dispatch.
    `lane` selects this query's slice of a stacked chunk (None for a solo
    run whose buffers are already 2-D)."""

    __slots__ = ("engine", "pq", "vars", "names", "fetch", "lane", "stats",
                 "trace")

    def __init__(self, engine: "QueryEngine", pq: "PreparedQuery",
                 vars: tuple[str, ...], names: tuple[str, ...],
                 fetch: _SharedFetch, lane: "int | None", stats: ExecStats,
                 trace=None):
        self.engine = engine
        self.pq = pq
        self.vars = vars
        self.names = names
        self.fetch = fetch
        self.lane = lane
        self.stats = stats
        self.trace = trace

    def resolve(self) -> ResultSet:
        traced = self.trace is not None
        t0 = time.perf_counter()
        c0 = time.thread_time() if traced else 0.0
        cols, valid, paid = self.fetch.fetch()
        c1 = time.thread_time() if traced else 0.0
        t1 = time.perf_counter()
        if self.lane is not None:
            cols, valid = cols[self.lane], valid[self.lane]
        ids = cols[valid]
        rows = self.engine._decode_numpy(self.names, ids)
        c2 = time.thread_time() if traced else 0.0
        t2 = time.perf_counter()
        if traced:
            # the sharing lanes' "transfer" span is their wait on the
            # paying lane's sync (usually ~0): attrs distinguish them
            self.trace.add_span("transfer", t0, t1, paid=paid,
                                transfer_s=round(self.fetch.transfer_s, 6),
                                cpu_s=c1 - c0)
            self.trace.add_span(
                "decode", t1, t2, rows=len(rows), cpu_s=c2 - c1,
                unbound_rows=int(np.count_nonzero(_loose_rows(ids))))
        self.stats.rows_emitted = len(rows)
        pq = self.pq
        pq.stats.add(self.stats)
        pq.last_stats = self.stats
        pq.n_runs += 1
        return ResultSet(self.vars, rows, self.stats)


class PreparedQuery:
    """A parsed, validated and planned query, reusable across runs.

    Holds per-handle accounting: `stats` accumulates ExecStats over every
    run (peak_capacity as a running max), `last_stats` is the most recent
    run's. The compiled executable itself lives in the engine's PlanCache,
    shared by every handle (and every client) with the same plan shape.
    """

    def __init__(self, engine: "QueryEngine", text: str, query: Query,
                 program: "_Program | None" = None):
        self.engine = engine
        self.text = text
        self.query = query
        # a follower rank takes rank 0's program (ShardedQueryEngine.follow)
        self._program = (
            engine._build_program(query) if program is None else program
        )
        self._batch_ctx: _BatchCtx | None = None  # run_batch staging cache
        self.stats = ExecStats()  # accumulated across runs
        self.last_stats: ExecStats | None = None
        self.n_runs = 0
        # the store version this handle was planned against. Runs stay
        # CORRECT regardless (scans re-stage at the current version each
        # run, under the store's snapshot lock); the pin records which
        # statistics the optimizer's choices reflect — see refresh().
        self.planned_version = engine.store.version

    def refresh(self) -> bool:
        """Re-plan against the store's current statistics if data changed
        since this handle was planned (or last refreshed).

        Optional: run() results are always computed on the live snapshot;
        refresh only updates the optimizer's join-order/backend choices
        (and this handle's pinned version). Returns True if re-planned."""
        if self.planned_version == self.engine.store.version:
            return False
        self._program = self.engine._build_program(self.query)
        self._batch_ctx = None
        self.planned_version = self.engine.store.version
        return True

    def run(self, trace=None) -> ResultSet:
        with self.engine._leading("run", [self]):
            return self._run_pending(trace).resolve()

    def _run_pending(self, trace=None) -> PendingDecode:
        """Dispatch the query, returning its result as a PendingDecode:
        device work is enqueued, host decode is not yet paid. run() is
        `_run_pending().resolve()`; the pipelined server resolves on a
        decode worker instead."""
        stats = ExecStats()
        rel = self.engine._execute_program(self._program, stats, trace)
        return PendingDecode(
            self.engine, self, self._program.projection, rel.schema,
            _SharedFetch(rel), None, stats, trace,
        )

    def explain(self, analyze: bool = False) -> str:
        """The plan explanation; `analyze=True` appends per-join-node
        actuals (estimated vs actual rows, bucket fill, overflows, the
        chosen backend) from the most recent run — running the query once
        first if this handle has never executed."""
        if analyze and self.last_stats is None:
            self.run()
        return self.engine._explain_program(self, self._program,
                                            analyze=analyze)


@dataclasses.dataclass
class UpdateResult:
    """Outcome of engine.update(): rows actually applied (set semantics —
    duplicate inserts and absent deletes are skipped) and the store
    version the update committed at."""

    inserted: int
    deleted: int
    n_ops: int
    version: int


@dataclasses.dataclass
class QueryEngine:
    store: TripleStore
    # where the engine runs: None = the card ("cuda"); construction raises
    # when there is none, unless the caller asks for "cpu"
    device: "str | torch.device | None" = None
    exact_count_pass: bool = True  # Mars two-pass vs double-on-overflow
    max_capacity: int = 1 << 24
    compiled: bool = True  # one-dispatch compiled pipeline vs eager loop
    plan_cache_entries: int = 256
    optimize: bool = True  # cost-based optimizer (False: legacy greedy)
    # physical join algebra: None = per-node cost-based choice (the
    # optimizer's selectivity x skew rule), "mr" / "matrix" = force every
    # join slot onto that backend (differential tests, benchmarks)
    join_backend: str | None = None
    warmup_path: str | None = None  # saved bucket signatures (save_cache)
    # lane cap per stacked run_batch dispatch: it bounds device memory per
    # dispatch, and chunks are cut at its pow-2 floor
    max_batch_width: int = 64
    # cross-shape padded stacking: run_batch coalesces near-miss PlanShapes
    # (identical but for pow-2 scan caps) into one stacked dispatch by
    # padding scans up to the group's max caps — padding rows are
    # valid=False, hence invisible to every masked operator. Merges are
    # taken only when every member shape is already warm and the padding
    # waste stays under pad_waste_limit (padded/real cell ratio - 1).
    pad_stacking: bool = True
    pad_waste_limit: float = 2.0
    # per-query span tracing: None (default) = off, zero overhead beyond
    # `trace is not None` checks on the dispatch path. The server shares
    # this Tracer so its request spans and the engine's dispatch spans
    # land in one trace tree.
    tracer: Tracer | None = None

    def __post_init__(self):
        if self.join_backend not in (None, "mr", "matrix"):
            raise ValueError(
                f"join_backend must be None, 'mr' or 'matrix' "
                f"(got {self.join_backend!r})"
            )
        self.device = resolve_device(self.device)
        self.plan_cache = PlanCache(self.plan_cache_entries)
        # learned bucket signatures from a previous process: a shape found
        # here compiles directly at the saved capacities, skipping the
        # eager calibration run entirely
        self._warm_caps: dict[plan_ir.PlanShape, tuple[int, ...]] = {}
        # persisted stacked (width, scan_axes) layouts per shape; files
        # written before run_batch existed simply have none, and files
        # from before broadcast scans carry widths only (all-stacked)
        self._warm_layouts: dict[plan_ir.PlanShape, tuple[tuple, ...]] = {}
        if self.warmup_path is not None:
            p = pathlib.Path(self.warmup_path)
            if p.exists():
                data = json.loads(p.read_text())
                # v3 files carry the writer's statistics catalog: seed the
                # store's lazy cache with it so backend choices (hence plan
                # shapes) match the saved signatures exactly. Older files
                # (v1/v2) have no catalog — the store computes its own,
                # which is identical for the same triples.
                stats_blob = data.get("statistics")
                if stats_blob is not None and self.store._statistics is None:
                    self.store._statistics = StoreStatistics.from_jsonable(
                        stats_blob
                    )
                for e in data["entries"]:
                    shape = plan_ir.shape_from_jsonable(e["shape"])
                    self._warm_caps[shape] = tuple(
                        int(c) for c in e["join_caps"]
                    )
                    layouts = [
                        (int(w), tuple(axes))
                        for w, axes in e.get("layouts", ())
                    ]
                    stacked = (0,) * len(shape.scan_schemas)
                    for w in e.get("widths", ()):
                        if not any(lw == int(w) for lw, _ in layouts):
                            layouts.append((int(w), stacked))
                    if layouts:
                        self._warm_layouts[shape] = tuple(layouts)
        # stacked-batch counters (cumulative; server stats report them)
        self.batch_width_hist: dict[int, int] = {}
        self.stacked_dispatches = 0
        self.stacked_queries = 0
        self.last_batch: list[BatchGroupStats] = []
        # cross-shape padding counters: merges taken / rejected by the
        # cost guard, and the cell ledger behind the waste ratio
        # (padded_cells >= real_cells; their gap is what padding burned)
        self.padded_groups = 0
        self.pad_rejects = 0
        self.padded_cells = 0
        self.real_cells = 0
        # correlates the N lane "dispatch" spans a stacked chunk fans out
        self._dispatch_seq = 0
        # cumulative host seconds from each program's enqueue to the read
        # of its flags (host time, not the card's)
        self.device_time_s = 0.0
        # the unified metrics registry: engine-side counters are bridged
        # in by a scrape-time collector (the dispatch path pays nothing);
        # the server registers its request metrics on this same registry
        self.metrics = MetricsRegistry()
        self._register_metrics()

    def _register_metrics(self) -> None:
        """Declare the engine's metrics and the collector that mirrors
        the hot-path counters into them at scrape time (naming scheme:
        mapsq_<subsystem>_<name>[_total|_seconds|_ratio])."""
        m = self.metrics
        g = {
            "plan_hits": m.counter(
                "mapsq_plan_cache_hits_total", "plan cache hits"),
            "plan_misses": m.counter(
                "mapsq_plan_cache_misses_total", "plan cache misses"),
            "plan_compiles": m.counter(
                "mapsq_plan_cache_compiles_total", "plan programs built"),
            "plan_entries": m.gauge(
                "mapsq_plan_cache_entries", "live plan cache entries"),
            "scan_hits": m.counter(
                "mapsq_scan_cache_hits_total", "scan cache hits"),
            "scan_misses": m.counter(
                "mapsq_scan_cache_misses_total", "scan cache misses"),
            "scan_evictions": m.counter(
                "mapsq_scan_cache_evictions_total",
                "scan cache entries dropped by writes"),
            "stacked_dispatches": m.counter(
                "mapsq_stacked_dispatches_total",
                "vmapped multi-query device dispatches"),
            "stacked_queries": m.counter(
                "mapsq_stacked_queries_total",
                "queries served by stacked dispatches"),
            "padded_groups": m.counter(
                "mapsq_padding_groups_total",
                "cross-shape padded merges taken"),
            "pad_rejects": m.counter(
                "mapsq_padding_rejects_total",
                "padded merges rejected by the waste guard"),
            "padded_cells": m.counter(
                "mapsq_padding_padded_cells_total",
                "scan cells dispatched incl. padding"),
            "real_cells": m.counter(
                "mapsq_padding_real_cells_total",
                "scan cells that were real data"),
            "device_time": m.counter(
                "mapsq_device_time_seconds_total",
                "host wall seconds inside device dispatch + sync"),
            "store_version": m.gauge(
                "mapsq_store_version", "store write version"),
            "store_tail": m.gauge(
                "mapsq_store_tail_rows", "uncompacted delta rows"),
            "store_tombstones": m.gauge(
                "mapsq_store_tombstones", "live tombstone rows"),
        }
        g["traces"] = m.counter(
            "mapsq_traces_total", "finished query traces")
        g["slow"] = m.counter(
            "mapsq_slow_queries_total",
            "traces over the slow-query threshold")

        def collect() -> None:
            pc = self.plan_cache.stats()
            g["plan_hits"].set_total(pc["hits"])
            g["plan_misses"].set_total(pc["misses"])
            g["plan_compiles"].set_total(pc["compiles"])
            g["plan_entries"].set(pc["entries"])
            sc = self.store.scan_cache_stats()
            g["scan_hits"].set_total(sc.get("hits", 0))
            g["scan_misses"].set_total(sc.get("misses", 0))
            g["scan_evictions"].set_total(sc.get("evictions", 0))
            g["stacked_dispatches"].set_total(self.stacked_dispatches)
            g["stacked_queries"].set_total(self.stacked_queries)
            g["padded_groups"].set_total(self.padded_groups)
            g["pad_rejects"].set_total(self.pad_rejects)
            g["padded_cells"].set_total(self.padded_cells)
            g["real_cells"].set_total(self.real_cells)
            g["device_time"].set_total(self.device_time_s)
            ws = self.store.write_stats()
            g["store_version"].set(ws["version"])
            g["store_tail"].set(ws["tail_rows"])
            g["store_tombstones"].set(ws["tombstones"])
            if self.tracer is not None:
                g["traces"].set_total(self.tracer.n_traces)
                g["slow"].set_total(self.tracer.n_slow)

        m.register_collector(collect)

    def _device_tick(self, stats: ExecStats, t0: float) -> float:
        """Account the host seconds from one program's enqueue (`t0`) to
        the read of its flags on BOTH ledgers (the engine-wide total and
        this run's ExecStats) so the engine total always equals the sum
        over runs. Returns the end stamp."""
        t1 = time.perf_counter()
        dt = t1 - t0
        self.device_time_s += dt
        stats.device_time_s += dt
        return t1

    def render_prometheus(self) -> str:
        return self.metrics.render_prometheus()

    def save_cache(self, path: str) -> int:
        """Serialize the plan cache's learned bucket signatures to JSON.

        A `QueryEngine(warmup_path=...)` in a restarted process compiles
        known shapes straight at these capacities — no calibration run.
        Each entry carries the stacked batch widths and (width, scan axes)
        layouts seen for the shape (built this process or inherited from a
        previous warmup file), so (shape, caps, width) signatures
        round-trip across restarts; files without them load unchanged.
        Returns the number of signatures written.
        """
        entries = [
            self._entry_jsonable(e) for e in self.plan_cache.entries()
        ]
        with self._leading("save_cache", entries):
            pathlib.Path(path).write_text(
                json.dumps(
                    {
                        "version": 3,
                        # the statistics catalog (incl. per-predicate
                        # degree skew) rides along so a restarted process
                        # makes the SAME backend decisions — shapes keep
                        # hashing to the saved signatures even if it
                        # recomputes nothing
                        "statistics": self.store.statistics.to_jsonable(),
                        "entries": entries,
                    }
                )
            )
        return len(entries)

    def _entry_jsonable(self, e: PlanCacheEntry) -> dict:
        """One warmup-file entry (the sharded engine appends its shuffle
        bucket caps here — keep the base format in one place)."""
        return {
            "shape": plan_ir.shape_to_jsonable(e.shape),
            "join_caps": list(e.join_caps),
            "widths": list(e.widths()),
            "layouts": [[w, list(axes)] for w, axes in e.layouts()],
        }

    def _leading(self, method: str, arg):
        """The context of a public call that every rank must make: a no-op
        here; ShardedQueryEngine's rank 0 sends the call to its followers
        first (its `arg`: the call's prepared queries, program, text or
        cache entries)."""
        return contextlib.nullcontext()

    # -- public API --------------------------------------------------------
    def prepare(self, text: str, trace=None) -> PreparedQuery:
        """Parse, validate and plan once; run (and re-run) later."""
        if trace is None:
            return PreparedQuery(self, text, parse(text))
        with trace.span("parse"):
            q = parse(text)
        with trace.span("optimize"):
            return PreparedQuery(self, text, q)

    def query(self, text: str) -> list[dict[str, str]]:
        """One-shot convenience: rows as {var: term} dicts."""
        return self.prepare(text).run().rows

    def execute(self, q: Query) -> tuple[Relation, ExecStats]:
        """Run a parsed query; the result Relation carries the projected
        (and DISTINCT-deduplicated, filtered, sliced) bindings."""
        stats = ExecStats()
        prog = self._build_program(q)
        with self._leading("execute", prog):
            rel = self._execute_program(prog, stats)
        return rel, stats

    def explain(self, text: str, analyze: bool = False) -> str:
        return self.prepare(text).explain(analyze=analyze)

    def update(self, text: str) -> UpdateResult:
        """Parse and apply `INSERT DATA { ... }` / `DELETE DATA { ... }`
        operations, in request order, atomically against queries (the
        whole request holds the store's write lock, so no run observes a
        half-applied request).

        Warm plan shapes survive the write: inserted rows and tombstone
        masks ride inside the existing pow-2 scan buckets, so previously
        compiled programs keep re-running at 0 compiles / 1 dispatch until
        a pattern outgrows its bucket."""
        req: UpdateRequest = parse_update(text)
        inserted = deleted = 0
        with self._leading("update", text), self.store.snapshot_lock():
            for op in req.ops:
                rows = [(tp.s, tp.p, tp.o) for tp in op.triples]
                if isinstance(op, algebra.InsertData):
                    inserted += self.store.insert_triples(rows)
                else:
                    deleted += self.store.delete_triples(rows)
        return UpdateResult(
            inserted, deleted, len(req.ops), self.store.version
        )

    def cache_stats(self) -> dict:
        return self.plan_cache.stats()

    def stats(self) -> dict:
        """One observability snapshot: plan cache, scan cache, and the
        store's write-path health (version, tail size, tombstone count,
        compaction count)."""
        return {
            "plan_cache": self.plan_cache.stats(),
            "scan_cache": self.store.scan_cache_stats(),
            "store": self.store.write_stats(),
        }

    def run_batch(self, prepared: list[PreparedQuery]) -> list[ResultSet]:
        """Execute a micro-batch, coalescing same-shape queries.

        Queries are grouped by compiled plan signature (PlanShape); each
        warm group runs as ONE stacked device dispatch per pow-2 width
        chunk (vmap over scan tuples and runtime constants), so N warm
        same-shape queries cost ceil(N / width) dispatches instead of N.
        Mixed batches fall back per-group; a cold group calibrates on its
        first query and stacks the rest. Results are positionally aligned
        with `prepared`. Per-group accounting lands in `self.last_batch`;
        the first failing query's exception is re-raised (use
        `run_batch_outcomes` for per-query error isolation).
        """
        outcomes = self.run_batch_outcomes(prepared)
        for oc in outcomes:
            if isinstance(oc, Exception):
                raise oc
        return outcomes

    def run_batch_outcomes(
        self, prepared: list[PreparedQuery]
    ) -> list["ResultSet | Exception"]:
        """run_batch with per-query error isolation: each slot is either a
        ResultSet or the exception that query raised (the server's batch
        path relies on one bad query never failing its batchmates)."""
        with self._leading("run_batch", prepared):
            return self._run_batch_impl(prepared, defer=False)

    def run_batch_pipelined(
        self, prepared: list[PreparedQuery], traces: "list | None" = None
    ) -> list["Exception | PendingDecode"]:
        """The serving pipeline's dispatch stage: like run_batch_outcomes,
        but slots whose device work dispatched cleanly come back as
        PendingDecode — the host decode (device→host transfer + row
        materialisation + per-handle accounting) has NOT been paid, and
        `.resolve()` may run on any thread. The batcher thread returns as
        soon as device work is enqueued, so dispatch of batch k+1 overlaps
        decode of batch k on the decode pool."""
        with self._leading("run_batch", prepared):
            return self._run_batch_impl(prepared, defer=True, traces=traces)

    def _run_batch_impl(
        self, prepared: list[PreparedQuery], defer: bool,
        traces: "list | None" = None,
    ) -> list:
        self.last_batch = []
        out: list = [None] * len(prepared)
        if traces is None:
            traces = [None] * len(prepared)
        if not self.compiled:
            group = BatchGroupStats(n_queries=len(prepared), fallback=True)
            self.last_batch.append(group)
            for i, pq in enumerate(prepared):
                out[i] = self._run_single(pq, group, defer, traces[i])
            return out
        # group by compiled plan signature (the PlanShape cache key)
        ctxs: list[_BatchCtx | None] = [None] * len(prepared)
        groups: OrderedDict[plan_ir.PlanShape, list[int]] = OrderedDict()
        for i, pq in enumerate(prepared):
            try:
                # staging is stable per handle between writes (program,
                # cache key) — compute once, reuse across micro-batches,
                # recompute after a store version bump (a write can move a
                # pattern into a bigger capacity bucket = a new shape)
                if (
                    pq._batch_ctx is None
                    or pq._batch_ctx.store_version != self.store.version
                ):
                    pq._batch_ctx = self._batch_context(pq._program)
                ctxs[i] = pq._batch_ctx
            except Exception as e:
                out[i] = e
                continue
            groups.setdefault(ctxs[i].shape, []).append(i)
        merged: OrderedDict[plan_ir.PlanShape, tuple[list[int], int, int]]
        if self.pad_stacking and len(groups) > 1:
            merged = self._coalesce_groups(groups)
        else:
            merged = OrderedDict(
                (s, (idxs, 1, 0)) for s, idxs in groups.items()
            )
        for shape, (idxs, n_shapes, n_compiles) in merged.items():
            self._run_group(
                shape, idxs, ctxs, prepared, out, defer,
                n_shapes=n_shapes, extra_compiles=n_compiles,
                traces=traces,
            )
        return out

    def _coalesce_groups(
        self, groups: "OrderedDict[plan_ir.PlanShape, list[int]]"
    ) -> "OrderedDict[plan_ir.PlanShape, tuple[list[int], int, int]]":
        """Cross-shape padded stacking: merge near-miss plan groups —
        identical PlanShapes except for pow-2 scan caps — into one padded
        group at the per-position MAX caps, so a mixed-shape batch still
        coalesces into few stacked dispatches. Padding rows carry
        valid=False, which every masked operator already treats as
        absent, so merged lanes decode exactly the rows their natural
        shape would have produced.

        Guards (a rejected bucket simply keeps its per-shape groups):
          * every member shape must be WARM — a padded group has no
            calibration story of its own, so the padded entry's join caps
            are derived as the elementwise max of the members' calibrated
            caps, which only exist once each member has run;
          * the cost guard: padding waste (padded/real scan-cell ratio
            minus 1) must stay <= pad_waste_limit, so one huge outlier
            shape cannot inflate every lane's scan buffers.
        """
        buckets: OrderedDict[tuple, list[plan_ir.PlanShape]] = OrderedDict()
        for shape in groups:
            key = dataclasses.replace(
                shape, scan_caps=(0,) * len(shape.scan_caps)
            )
            buckets.setdefault(key, []).append(shape)
        merged: OrderedDict[
            plan_ir.PlanShape, tuple[list[int], int, int]
        ] = OrderedDict()
        for members in buckets.values():
            if len(members) < 2:
                s = members[0]
                merged[s] = (groups[s], 1, 0)
                continue
            entries = [self.plan_cache.get(s) for s in members]
            target = tuple(
                max(s.scan_caps[j] for s in members)
                for j in range(len(members[0].scan_caps))
            )
            n_q = sum(len(groups[s]) for s in members)
            real = sum(
                len(groups[s]) * sum(s.scan_caps) for s in members
            )
            padded = n_q * sum(target)
            ok = all(e is not None for e in entries)
            if ok and (padded - real) / real > self.pad_waste_limit:
                self.pad_rejects += 1
                ok = False
            if not ok:
                for s in members:
                    merged[s] = (groups[s], 1, 0)
                continue
            padded_shape = dataclasses.replace(members[0], scan_caps=target)
            n_compiles = 0
            if self.plan_cache.get(padded_shape) is None:
                join_caps = tuple(
                    max(e.join_caps[j] for e in entries)
                    for j in range(len(entries[0].join_caps))
                )
                sink = ExecStats()
                self._compile_entry(padded_shape, join_caps, sink)
                n_compiles = sink.n_compiles
            idxs = sorted(
                i for s in members for i in groups[s]
            )  # arrival order across member groups
            merged[padded_shape] = (idxs, len(members), n_compiles)
            self.padded_groups += 1
            self.padded_cells += padded
            self.real_cells += real
        return merged

    # -- batched execution internals ---------------------------------------
    def _batch_context(self, prog: _Program) -> _BatchCtx:
        with self.store.snapshot_lock():
            _, shape, inverse = self._canonicalize(prog)
            version = self.store.version
        return _BatchCtx(
            prog=prog, shape=shape, inverse=inverse, store_version=version
        )

    def _run_single(
        self, pq: PreparedQuery, group: BatchGroupStats, defer: bool = False,
        trace=None,
    ) -> "ResultSet | Exception | PendingDecode":
        """Sequential path inside run_batch: the normal per-query path,
        with its dispatch/compile counts folded into the group's. With
        `defer`, host decode is left pending for the decode stage. A
        failure is this query's outcome, returned to its caller."""
        try:
            pending = pq._run_pending(trace)
        except Exception as e:
            return e
        group.n_dispatches += pending.stats.n_dispatches
        group.n_compiles += pending.stats.n_compiles
        return pending if defer else pending.resolve()

    def _run_group(
        self,
        shape: plan_ir.PlanShape,
        idxs: list[int],
        ctxs: list["_BatchCtx | None"],
        prepared: list[PreparedQuery],
        out: list,
        defer: bool = False,
        n_shapes: int = 1,
        extra_compiles: int = 0,
        traces: "list | None" = None,
    ) -> None:
        if traces is None:
            traces = [None] * len(out)
        group = BatchGroupStats(
            n_queries=len(idxs),
            padded=n_shapes > 1,
            n_shapes=n_shapes,
            n_compiles=extra_compiles,  # the padded entry's compile
        )
        self.last_batch.append(group)
        pos = 0
        if self.plan_cache.get(shape) is None:
            # cold shape: the first query runs the normal path (calibration
            # or warmup compile), populating the cache the rest stack on
            group.cold = True
            out[idxs[0]] = self._run_single(
                prepared[idxs[0]], group, defer, traces[idxs[0]]
            )
            pos = 1
        # chunk at the pow-2 floor of the lane cap: max_batch_width bounds
        # device memory per dispatch, so it must never round UP
        width_cap = plan_ir.floor_pow2(self.max_batch_width)
        while pos < len(idxs):
            chunk = idxs[pos:pos + width_cap]
            pos += len(chunk)
            if len(chunk) < 2 or self.plan_cache.get(shape) is None:
                for i in chunk:
                    out[i] = self._run_single(
                        prepared[i], group, defer, traces[i]
                    )
                continue
            try:
                self._run_chunk_stacked(
                    shape, chunk, ctxs, prepared, out, group, defer, traces
                )
            except MemoryError:
                # a lane's bucket regrow passed max_capacity: re-run the
                # chunk's queries one by one so only the culprit fails.
                # Every other failure of a stacked dispatch (a refused
                # kernel launch, a CUDA error) propagates.
                group.fallback = True
                for i in chunk:
                    out[i] = self._run_single(
                        prepared[i], group, defer, traces[i]
                    )

    def _stage_chunk(
        self, shape: plan_ir.PlanShape, lanes: list[_BatchCtx], n: int
    ) -> _ChunkInputs:
        """The device inputs of one stacked dispatch over `lanes` (the
        chunk's contexts, trailing padding lanes repeating lane 0), of
        which the first `n` carry real queries.

        Per scan position: if every lane scans the SAME pattern (e.g. a
        batch differing only in FILTER constants) AND its staged buffer
        already sits at the group's capacity, the device buffer ships once
        and vmap broadcasts it (in_dims None) instead of staging W stacked
        copies. For a PADDED group (`shape` is the coalesced max-caps
        signature) every stacked lane is padded up to `shape.scan_caps`."""
        scans: list[Relation] = []
        axes: list[int | None] = []
        with self.store.snapshot_lock():  # one store version per chunk
            for j, schema in enumerate(shape.scan_schemas):
                cap = shape.scan_caps[j]
                tps = tuple(c.prog.patterns[j] for c in lanes)
                rel = None
                if len({self.store._scan_key(tp) for tp in tps}) == 1:
                    rel = self.store.match_pattern_device(tps[0], self.device)
                if rel is not None and rel.capacity == cap:
                    scans.append(Relation(schema, rel.cols, rel.valid))
                    axes.append(None)
                else:
                    scans.append(Relation(
                        schema,
                        *self.store.stacked_scan_device(
                            tps, self.device, cap=cap
                        ),
                    ))
                    axes.append(0)
            version = self.store.version
        return _ChunkInputs(
            tuple(scans),
            tuple(axes),
            torch.from_numpy(
                np.stack([c.prog.consts_i for c in lanes])
            ).to(self.device),
            torch.from_numpy(
                np.stack([c.prog.consts_f for c in lanes])
            ).to(self.device),
            self.store.numeric_values_device(self.device),
            torch.from_numpy(np.arange(len(lanes)) < n).to(self.device),
            version,
        )

    def _run_chunk_stacked(
        self,
        shape: plan_ir.PlanShape,
        chunk: list[int],
        ctxs: list["_BatchCtx | None"],
        prepared: list[PreparedQuery],
        out: list,
        group: BatchGroupStats,
        defer: bool = False,
        traces: "list | None" = None,
    ) -> None:
        """ONE stacked dispatch for a chunk of warm same-shape queries."""
        entry = self.plan_cache.get(shape)
        n = len(chunk)
        width = plan_ir.bucket_width(n, self.max_batch_width)
        # pad trailing lanes with lane 0's inputs; lane_active masks them
        lanes = [ctxs[i] for i in chunk] + [ctxs[chunk[0]]] * (width - n)
        inp = self._stage_chunk(shape, lanes, n)
        group.n_broadcast_scans += sum(1 for a in inp.scan_axes if a is None)
        stats = ExecStats(
            n_joins=shape.n_joins(),
            cache_hits=1,
            batch_width=width,
            store_version=inp.store_version,
        )
        self.plan_cache.hits += n
        # retroactive span intervals, fanned out to every lane trace after
        # the chunk succeeds (one device dispatch -> N lane "dispatch"
        # spans correlated by a shared dispatch_id): (name, t0, t1, the
        # dispatch's enqueue from `_enqueue` or None)
        events: list[tuple[str, float, float, "tuple | None"]] = []
        traced = any(traces[i] is not None for i in chunk) if traces else False
        ovf_counts = [0] * shape.n_joins()
        try:
            while True:
                bexec = entry.batched.get((width, inp.scan_axes))
                if bexec is None:
                    tc0 = time.perf_counter()
                    bexec = self._build_batched(entry, width, inp.scan_axes)
                    events.append(
                        ("compile", tc0, time.perf_counter(), None)
                    )
                    entry.batched[(width, inp.scan_axes)] = bexec
                    stats.n_compiles += 1
                    self.plan_cache.compiles += 1
                stats.n_dispatches += 1
                t0 = time.perf_counter()
                (rel_b, totals_b, flags_b), enq = _enqueue(
                    traced, bexec, inp.scans, inp.consts_i, inp.consts_f,
                    inp.num_vals, inp.active,
                )
                flags_np = flags_b.cpu().numpy()  # the single host sync
                events.append(
                    ("dispatch", t0, self._device_tick(stats, t0), enq)
                )
                if not flags_np.any():
                    break
                # some lane overflowed a bucket: grow each flagged join to
                # the worst lane's exact total, recompile, retry the chunk
                stats.n_retries += 1
                totals_np = totals_b.cpu().numpy()
                overflowed = [
                    bool(flags_np[:, j].any())
                    for j in range(flags_np.shape[1])
                ]
                for j, f in enumerate(overflowed):
                    ovf_counts[j] += int(f)
                new_caps = plan_ir.grow_join_caps(
                    entry.join_caps,
                    [int(totals_np[:, j].max())
                     for j in range(totals_np.shape[1])],
                    overflowed,
                )
                if max(new_caps) > self.max_capacity:
                    raise MemoryError(
                        f"join result exceeds {self.max_capacity}"
                    )
                entry = self._compile_entry(shape, new_caps, stats)
        finally:
            # the group ledger counts every dispatch and compile, including
            # those of a chunk that then fell back to the sequential path
            group.n_dispatches += stats.n_dispatches
            group.n_compiles += stats.n_compiles
        # the serving counters only describe *successful* stacked service,
        # so queries_per_dispatch can never be skewed by a failed chunk
        group.widths = group.widths + (width,)
        self.stacked_dispatches += stats.n_dispatches
        self.batch_width_hist[width] = (
            self.batch_width_hist.get(width, 0) + stats.n_dispatches
        )
        self.stacked_queries += n
        caps = entry.compiled.plan.join_caps
        stats.peak_join_bucket = max(caps) if caps else 0
        stats.peak_capacity = entry.compiled.plan.max_capacity()
        stats.join_caps = tuple(caps)
        stats.join_overflows = tuple(ovf_counts)
        self._emit_chunk_results(
            rel_b, chunk, ctxs, prepared, out, stats, defer,
            self._chunk_lane_totals(totals_b), traces=traces, events=events,
        )

    def _chunk_lane_totals(self, totals_b) -> tuple[np.ndarray, np.ndarray]:
        """Stacked totals -> per-lane (global, worst-shard) actuals, each
        (width, n_joins). On the single-device engine they coincide; the
        sharded override sums/maxes away its shard axis."""
        t = totals_b.cpu().numpy()
        return t, t

    def _emit_chunk_results(
        self,
        rel_b: Relation,
        chunk: list[int],
        ctxs: list["_BatchCtx | None"],
        prepared: list[PreparedQuery],
        out: list,
        stats: ExecStats,
        defer: bool,
        lane_totals: tuple[np.ndarray, np.ndarray],
        traces: "list | None" = None,
        events: "list | None" = None,
    ) -> None:
        """Unstack a chunk's result: ONE device→host transfer shared by
        every lane (lazy — the first decode consumer pays it), then
        per-lane row decode under each query's own variable names, either
        inline or left pending for the serving decode pool. `lane_totals`
        holds each lane's exact join totals and worst-shard totals, each
        (width, n_joins)."""
        fetch = _SharedFetch(rel_b)
        schema = rel_b.schema
        if events:
            self._dispatch_seq += 1
        for k, i in enumerate(chunk):
            names = tuple(ctxs[i].inverse[v] for v in schema)
            st = dataclasses.replace(stats)
            st.join_totals = tuple(int(x) for x in lane_totals[0][k])
            st.join_worst = tuple(int(x) for x in lane_totals[1][k])
            # the chunk's dispatch wall is shared: attribute an equal share
            # to each lane so the engine-level device_time_s stays equal to
            # the sum over per-run ExecStats
            st.device_time_s = stats.device_time_s / len(chunk)
            trace = traces[i] if traces is not None else None
            if trace is not None and events:
                for event in events:
                    _add_event(
                        trace, *event,
                        dispatch_id=self._dispatch_seq,
                        width=stats.batch_width, stacked=True, lane=k,
                    )
            pending = PendingDecode(
                self, prepared[i], names, names, fetch, k, st, trace,
            )
            out[i] = pending if defer else pending.resolve()

    # -- planning ----------------------------------------------------------
    def _lower_expr(
        self,
        expr: algebra.FilterExpr,
        id_consts: list[int],
        f_consts: list[float],
    ) -> plan_ir.FilterExpr:
        """Algebra filter expression -> plan expression, allocating the
        runtime-constant slots its literal leaves reference."""
        if isinstance(expr, algebra.Compare):
            if isinstance(expr.rhs, algebra.Var):
                return ("cmp", expr.lhs, expr.op, "var", expr.rhs.name)
            if isinstance(expr.rhs, algebra.NumLit):
                idx = len(f_consts)
                f_consts.append(expr.rhs.value)
                return ("cmp", expr.lhs, expr.op, "num", idx)
            # TermLit: identity comparison; unknown terms can never match
            # a bound variable, -1 encodes that correctly
            tid = self.store.dictionary.lookup(expr.rhs.lexical)
            idx = len(id_consts)
            id_consts.append(-1 if tid is None else tid)
            return ("cmp", expr.lhs, expr.op, "id", idx)
        tag = "and" if isinstance(expr, algebra.And) else "or"
        return (
            tag,
            tuple(
                self._lower_expr(c, id_consts, f_consts)
                for c in expr.children
            ),
        )

    def _build_program(self, q: Query) -> _Program:
        # the sharded engine reports its shard count so the join ordering
        # can weigh shuffle cost; single-device engines pass 1 (no-op)
        plan = optimizer.optimize(
            q, self.store, enabled=self.optimize,
            n_shards=getattr(self, "n_shards", 1),
        )
        patterns = list(plan.all_patterns())
        opt_groups = tuple(
            plan_ir.GroupSpec(len(g), plan.opt_cross_flags[i])
            for i, g in enumerate(plan.opt_groups)
        )
        union_groups = tuple(
            plan_ir.GroupSpec(len(b), plan.branch_cross_flags[i])
            for i, b in enumerate(plan.branches)
        )
        id_consts: list[int] = []
        f_consts: list[float] = []
        # a conjunct the optimizer distributed into several UNION branches
        # is lowered once and shares its constant slots across the copies
        lowered: dict[int, plan_ir.FilterExpr] = {}
        specs: list[plan_ir.FilterSpec] = []
        for stage, expr in plan.filters:
            key = id(expr)
            if key not in lowered:
                lowered[key] = self._lower_expr(expr, id_consts, f_consts)
            specs.append((stage, lowered[key]))
        n_consts = (len(id_consts), len(f_consts))
        has_slice = q.has_slice()
        if has_slice:
            limit = q.limit if q.limit is not None else _NO_LIMIT
            id_consts += [min(q.offset, _NO_LIMIT), min(limit, _NO_LIMIT)]
        return _Program(
            q,
            plan,
            patterns,
            plan.cross_flags,
            opt_groups,
            union_groups,
            plan.has_required,
            tuple(specs),
            n_consts,
            np.asarray(id_consts, np.int32),
            np.asarray(f_consts, np.float32),
            tuple(q.projection()),
            q.distinct,
            has_slice,
        )

    def _shape_for(
        self,
        prog: _Program,
        schemas: tuple[tuple[str, ...], ...],
        caps: tuple[int, ...],
        rename: dict[str, str] | None = None,
    ) -> plan_ir.PlanShape:
        r = rename or {}

        def rn(v: str) -> str:
            return r.get(v, v)

        specs = tuple(
            (stage, plan_ir.rename_expr(expr, r))
            for stage, expr in prog.filters
        )
        # per-slot physical algebra rides in the shape (a backend flip is
        # a different compiled program); an engine-level override forces
        # every slot, otherwise the optimizer's per-node choice stands
        backends = prog.plan.join_backends
        if self.join_backend is not None:
            backends = (self.join_backend,) * len(backends)
        return plan_ir.make_shape(
            tuple(tuple(rn(v) for v in s) for s in schemas),
            caps,
            prog.cross_flags,
            tuple(rn(v) for v in prog.projection),
            prog.distinct,
            opt_groups=prog.opt_groups,
            union_groups=prog.union_groups,
            has_required=prog.has_required,
            filters=specs,
            n_consts=prog.n_consts,
            has_slice=prog.has_slice,
            prune=prog.plan.prune,
            join_backends=backends,
            scan_parts=self._scan_parts(prog, schemas),
        )

    def _scan_parts(
        self,
        prog: _Program,
        schemas: tuple[tuple[str, ...], ...],
    ) -> tuple[int, ...]:
        """Per-scan partition column (index into the scan's schema; -1 =
        unpartitioned). The single-device store is one shard, so nothing
        is partitioned; the sharded engine overrides with the store's
        subject-hash placement. Column positions are invariant under the
        canonical rename, so the shape stays structurally hashable."""
        return ()

    # -- execution ---------------------------------------------------------
    def _execute_program(
        self, prog: _Program, stats: ExecStats, trace=None
    ) -> Relation:
        if self.compiled:
            return self._execute_compiled(prog, stats, trace)
        with self.store.snapshot_lock():  # consistent version across scans
            scans = tuple(
                self.store.match_pattern(tp, self.device)
                for tp in prog.patterns
            )
            stats.store_version = self.store.version
        shape = self._shape_for(
            prog,
            tuple(s.schema for s in scans),
            tuple(s.capacity for s in scans),
        )
        t0 = time.perf_counter()
        rel, totals = self._eval_shape_eager(shape, scans, prog, stats)
        stats.join_totals = tuple(totals)
        stats.join_worst = stats.join_totals
        if trace is not None:
            trace.add_span("dispatch", t0, time.perf_counter(), eager=True)
        return rel

    def _decode_rows(self, rel: Relation) -> list[dict[str, str]]:
        return self._decode_numpy(rel.schema, rel.to_numpy())

    def _decode_numpy(
        self, schema: tuple[str, ...], rows: np.ndarray
    ) -> list[dict[str, str]]:
        """(n, len(schema)) ids -> n dicts {var: term}, in `rows`' order
        with keys in `schema`'s. Rows with every cell bound take one
        gather through the dictionary's term table and are zipped into
        dicts (`_dict_rows`); a row holding UNBOUND (an OPTIONAL group's
        unmatched row) is decoded alone and omits its unbound variables."""
        d = self.store.dictionary
        loose = _loose_rows(rows)
        if not loose.any():
            return _dict_rows(schema, d.decode_ids(rows))
        tight = iter(_dict_rows(schema, d.decode_ids(rows[~loose])))
        partial = iter([
            {
                v: d.decode(int(t))
                for v, t in zip(schema, row)
                if int(t) != UNBOUND
            }
            for row in rows[loose]
        ])
        return [next(partial) if lo else next(tight) for lo in loose.tolist()]

    # -- eager evaluator ---------------------------------------------------
    def _eval_shape_eager(
        self,
        shape: plan_ir.PlanShape,
        scans: tuple[Relation, ...],
        prog: _Program,
        stats: ExecStats,
    ) -> tuple[Relation, list[int]]:
        """Operator-at-a-time evaluation with exact (count-pass) bucket
        sizing. Returns the result and each join's exact total in the same
        order the compiled program reports them — the totals are what the
        compiled path calibrates its buckets on, so filter stages must be
        applied at exactly the positions build_plan interleaves them."""
        totals: list[int] = []
        consts_i, consts_f, num_vals = self._device_consts(prog)
        by_stage: dict[tuple, list[plan_ir.FilterExpr]] = {}
        for stage, expr in shape.filters:
            by_stage.setdefault(stage, []).append(expr)

        def apply_stage(rel: Relation, stage: tuple) -> Relation:
            exprs = by_stage.get(stage)
            if not exprs:
                return rel
            keep = mj.filter_mask(
                rel, tuple(exprs), consts_i, consts_f, num_vals
            )
            return Relation(rel.schema, rel.cols, keep)

        scan_idx = 0

        def next_scan() -> Relation:
            nonlocal scan_idx
            rel = apply_stage(scans[scan_idx], ("scan", scan_idx))
            scan_idx += 1
            return rel

        def chain(
            n_scans: int,
            cross_flags: tuple[bool, ...],
            req_stages: bool = False,
        ) -> Relation:
            acc = next_scan()
            for j, is_cross in enumerate(cross_flags):
                acc, total = self._join_once(
                    acc, next_scan(), is_cross, stats
                )
                totals.append(total)
                if req_stages:
                    acc = apply_stage(acc, ("req", j))
            return acc

        acc: Relation | None = None
        if shape.has_required:
            acc = chain(
                shape.n_required, shape.cross_flags, req_stages=True
            )
        for gi, g in enumerate(shape.opt_groups):
            grp = chain(g.n_scans, g.cross_flags)
            stats.n_joins += 1
            stats.n_dispatches += 1
            t0 = time.perf_counter()
            total = int(mj.mr_join_count(acc, grp))
            self._device_tick(stats, t0)
            stats.n_count_passes += 1
            cap = max(1, next_pow2(total))
            stats.n_dispatches += 1
            t0 = time.perf_counter()
            out, _, overflow = mj.left_join(acc, grp, capacity=cap)
            ok = not bool(overflow)
            self._device_tick(stats, t0)
            assert ok
            stats.peak_capacity = max(
                stats.peak_capacity, cap + acc.capacity
            )
            stats.peak_join_bucket = max(stats.peak_join_bucket, cap)
            totals.append(total)
            acc = apply_stage(out, ("opt", gi))
        if shape.union_groups:
            children: list[Relation] = []
            for bi, g in enumerate(shape.union_groups):
                branch = chain(g.n_scans, g.cross_flags)
                if acc is not None:
                    shared = [v for v in acc.schema if v in branch.schema]
                    branch, total = self._join_once(
                        acc, branch, not shared, stats
                    )
                    totals.append(total)
                children.append(apply_stage(branch, ("bjoin", bi)))
            schema: list[str] = []
            for c in children:
                for v in c.schema:
                    if v not in schema:
                        schema.append(v)
            acc = mj.union_all(children, tuple(schema))
        acc = apply_stage(acc, ("top",))
        acc = acc.project(list(shape.projection))
        if shape.distinct:
            acc = mj.distinct(acc)  # device-side dedup before decode
        if shape.has_slice:
            oi, li = shape.slice_const_indices()
            acc = mj.slice_valid(
                acc, int(prog.consts_i[oi]), int(prog.consts_i[li])
            )
        return acc, totals

    def _join_once(
        self, left: Relation, right: Relation, is_cross: bool, stats: ExecStats
    ) -> tuple[Relation, int]:
        # every branch ends in a host sync (int()/bool() of a device
        # scalar), so the _device_tick interval covers dispatch + sync —
        # the same accounting the compiled paths use
        stats.n_joins += 1
        if is_cross:
            cap = max(1, next_pow2(left.capacity * right.capacity))
            stats.n_dispatches += 1
            t0 = time.perf_counter()
            out, total, overflow = mj.cross_join(left, right, capacity=cap)
            ok, total = not bool(overflow), int(total)
            self._device_tick(stats, t0)
            assert ok
            stats.peak_capacity = max(stats.peak_capacity, cap)
            stats.peak_join_bucket = max(stats.peak_join_bucket, cap)
            return mj.compact(out), total
        if self.exact_count_pass:
            stats.n_dispatches += 1
            t0 = time.perf_counter()
            total = int(mj.mr_join_count(left, right))
            self._device_tick(stats, t0)
            stats.n_count_passes += 1
            cap = max(1, next_pow2(total))
            stats.n_dispatches += 1
            t0 = time.perf_counter()
            out, _, overflow = mj.mr_join(left, right, capacity=cap)
            ok = not bool(overflow)
            self._device_tick(stats, t0)
            assert ok
            stats.peak_capacity = max(stats.peak_capacity, cap)
            stats.peak_join_bucket = max(stats.peak_join_bucket, cap)
            return out, total
        # double-on-overflow: start at the larger input's capacity and
        # retry at twice the bucket until the join fits
        cap = max(left.capacity, right.capacity)
        while True:
            stats.n_dispatches += 1
            t0 = time.perf_counter()
            out, total, overflow = mj.mr_join(left, right, capacity=cap)
            overflowed = bool(overflow)
            self._device_tick(stats, t0)
            stats.peak_capacity = max(stats.peak_capacity, cap)
            stats.peak_join_bucket = max(stats.peak_join_bucket, cap)
            if not overflowed:
                return out, int(total)
            stats.n_retries += 1
            cap *= 2
            if cap > self.max_capacity:
                raise MemoryError(f"join result exceeds {self.max_capacity}")

    # -- compiled path -----------------------------------------------------
    def _canonicalize(
        self, prog: _Program
    ) -> tuple[tuple[Relation, ...], plan_ir.PlanShape, dict[str, str]]:
        """Device scans + cache key for a program: upload-once scans
        (bucketed pow-2 capacities), variable names canonicalised so
        structurally-equal queries share one compiled program (constants
        live in the scan data and the runtime-constant inputs, not here).
        Returns (canonical scans, shape, canonical -> original names).

        Staging runs under the store's snapshot lock so every scan reflects
        ONE store version even while concurrent updates land."""
        with self.store.snapshot_lock():
            scans = tuple(self._device_scan(tp) for tp in prog.patterns)
        schemas = tuple(s.schema for s in scans)
        rename = plan_ir.canonical_renaming(schemas)
        inverse = {c: o for o, c in rename.items()}
        canon_scans = tuple(
            Relation(tuple(rename[v] for v in s.schema), s.cols, s.valid)
            for s in scans
        )
        shape = self._shape_for(
            prog, schemas, self._scan_caps(scans), rename
        )
        return canon_scans, shape, inverse

    def _device_scan(self, tp: TriplePattern) -> Relation:
        """A pattern's scan staged on the engine's device (the sharded
        engine's ranks stage their own shard's block)."""
        return self.store.match_pattern_device(tp, self.device)

    def _scan_caps(
        self, scans: tuple[Relation, ...]
    ) -> tuple[int, ...]:
        """Scan capacities as the PlanShape records them (the sharded
        engine overrides this to report PER-SHARD buckets)."""
        return tuple(s.capacity for s in scans)

    def _device_consts(
        self, prog: _Program
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Device placement of the runtime-constant inputs."""
        return (
            torch.from_numpy(prog.consts_i).to(self.device),
            torch.from_numpy(prog.consts_f).to(self.device),
            self.store.numeric_values_device(self.device),
        )

    def _caps_from_totals(self, totals: list[int]) -> tuple[int, ...]:
        """Join bucket capacities from the calibration run's exact totals
        (the sharded engine overrides this to size PER-SHARD buckets)."""
        return tuple(plan_ir.bucket_capacity(t) for t in totals)

    def _execute_compiled(
        self, prog: _Program, stats: ExecStats, trace=None
    ) -> Relation:
        with self.store.snapshot_lock():
            canon_scans, shape, inverse = self._canonicalize(prog)
            stats.store_version = self.store.version
        stats.n_joins = shape.n_joins()
        consts_i, consts_f, num_vals = self._device_consts(prog)

        entry = self.plan_cache.get(shape)
        if entry is None:
            rel = self._compiled_cold(
                shape, canon_scans, prog, stats, trace
            )
        else:
            rel = self._compiled_warm(
                shape, entry, canon_scans, consts_i, consts_f, num_vals,
                stats, trace,
            )
        # back to the query's own variable names
        return Relation(
            tuple(inverse[v] for v in rel.schema), rel.cols, rel.valid
        )

    def _compiled_cold(
        self,
        shape: plan_ir.PlanShape,
        canon_scans: tuple[Relation, ...],
        prog: _Program,
        stats: ExecStats,
        trace=None,
    ) -> Relation:
        """Cache miss: the eager evaluator's count passes calibrate the join
        buckets; compile at those shapes; serve this query from the eager
        result (the compiled program takes over from the next query on).
        A shape with a saved warmup signature skips the calibration run and
        compiles straight at the persisted capacities."""
        stats.cache_misses += 1
        self.plan_cache.misses += 1
        warm_caps = self._warm_caps.get(shape)
        if warm_caps is not None and len(warm_caps) == shape.n_joins():
            entry = self._compile_entry(
                shape, warm_caps, stats, trace=trace, precompile=True
            )
            return self._dispatch_entry(
                shape, entry, canon_scans, *self._device_consts(prog),
                stats, trace,
            )
        eager_stats = ExecStats()
        t0 = time.perf_counter()
        rel, totals = self._eval_shape_eager(
            shape, canon_scans, prog, eager_stats
        )
        if trace is not None:
            trace.add_span(
                "dispatch", t0, time.perf_counter(), calibration=True
            )
        stats.n_count_passes += eager_stats.n_count_passes
        stats.n_dispatches += eager_stats.n_dispatches
        stats.n_retries += eager_stats.n_retries
        stats.device_time_s += eager_stats.device_time_s
        stats.peak_capacity = max(
            stats.peak_capacity, eager_stats.peak_capacity
        )
        stats.peak_join_bucket = max(
            stats.peak_join_bucket, eager_stats.peak_join_bucket
        )
        join_caps = self._caps_from_totals(totals)
        stats.join_totals = tuple(totals)
        stats.join_worst = stats.join_totals
        stats.join_caps = join_caps
        self._compile_entry(
            shape, join_caps, stats, trace=trace, precompile=True
        )
        return rel

    def _compiled_warm(
        self,
        shape: plan_ir.PlanShape,
        entry: PlanCacheEntry,
        canon_scans: tuple[Relation, ...],
        consts_i: torch.Tensor,
        consts_f: torch.Tensor,
        num_vals: torch.Tensor,
        stats: ExecStats,
        trace=None,
    ) -> Relation:
        stats.cache_hits += 1
        self.plan_cache.hits += 1
        return self._dispatch_entry(
            shape, entry, canon_scans, consts_i, consts_f, num_vals,
            stats, trace,
        )

    def _dispatch_entry(
        self,
        shape: plan_ir.PlanShape,
        entry: PlanCacheEntry,
        canon_scans: tuple[Relation, ...],
        consts_i: torch.Tensor,
        consts_f: torch.Tensor,
        num_vals: torch.Tensor,
        stats: ExecStats,
        trace=None,
    ) -> Relation:
        ovf_counts = [0] * shape.n_joins()
        while True:
            stats.n_dispatches += 1
            t0 = time.perf_counter()
            (rel, totals, flags), enq = _enqueue(
                trace is not None, entry.compiled,
                canon_scans, consts_i, consts_f, num_vals,
            )
            stats.peak_capacity = max(
                stats.peak_capacity, entry.compiled.plan.max_capacity()
            )
            caps = entry.compiled.plan.join_caps
            stats.peak_join_bucket = max(
                stats.peak_join_bucket, max(caps) if caps else 0
            )
            flags_np = flags.cpu().numpy()  # the single host sync
            t1 = self._device_tick(stats, t0)
            if trace is not None:
                _add_event(trace, "dispatch", t0, t1, enq)
            if not flags_np.any():
                stats.join_totals = tuple(
                    int(t) for t in totals.cpu().numpy()
                )
                stats.join_worst = stats.join_totals
                stats.join_caps = tuple(caps)
                stats.join_overflows = tuple(ovf_counts)
                return rel
            # bucket overflow: grow from the exact totals, recompile, retry
            stats.n_retries += 1
            for j, f in enumerate(flags_np):
                ovf_counts[j] += int(bool(f))
            new_caps = plan_ir.grow_join_caps(
                entry.join_caps,
                [int(t) for t in totals.cpu().numpy()],
                [bool(f) for f in flags_np],
            )
            if max(new_caps) > self.max_capacity:
                raise MemoryError(
                    f"join result exceeds {self.max_capacity}"
                )
            entry = self._compile_entry(shape, new_caps, stats, trace=trace)

    def _compile_entry(
        self,
        shape: plan_ir.PlanShape,
        join_caps: tuple[int, ...],
        stats: ExecStats,
        trace=None,
        precompile: bool = False,
        shuffle_caps: "tuple[int, ...] | None" = None,
    ) -> PlanCacheEntry:
        """Build the program for (shape, join_caps) and cache it. The cold
        paths pass `precompile` to build the stacked layouts a previous
        process persisted too; a regrow does not (the next regrow would
        discard them). `shuffle_caps` are the sharded engine's shuffle
        buckets (see _compile)."""
        t_compile = time.perf_counter()
        compiled = self._compile(shape, join_caps, shuffle_caps)
        stats.n_compiles += 1
        self.plan_cache.compiles += 1
        entry = PlanCacheEntry(
            shape, join_caps, compiled,
            warm_layouts=self._warm_layouts.get(shape, ()),
        )
        if precompile:
            self._precompile_batched(entry, stats)
        self.plan_cache.put(shape, entry)
        if trace is not None:
            trace.add_span(
                "compile", t_compile, time.perf_counter(),
                n_joins=len(join_caps),
            )
        return entry

    def _compile(self, shape: plan_ir.PlanShape, join_caps: tuple[int, ...],
                 shuffle_caps: "tuple[int, ...] | None"):
        """The program for one (shape, join caps) point; the sharded
        engine's also takes per-(site, stage) shuffle buckets, which one
        device has none of."""
        assert shuffle_caps is None, shuffle_caps
        return ex.compile_plan(plan_ir.build_plan(shape, join_caps))

    def _precompile_batched(
        self, entry: PlanCacheEntry, stats: ExecStats
    ) -> None:
        """Build the stacked programs for the (width, scan-layout)
        signatures a previous process persisted (save_cache /
        warmup_path), so a restarted server's first micro-batch dispatches
        warm."""
        width_cap = plan_ir.floor_pow2(self.max_batch_width)
        for w, axes in entry.warm_layouts:
            if (
                (w, axes) in entry.batched
                or not 2 <= w <= width_cap
                or len(axes) != len(entry.shape.scan_schemas)
            ):
                continue
            entry.batched[(w, axes)] = self._build_batched(entry, w, axes)
            stats.n_compiles += 1
            self.plan_cache.compiles += 1

    def _build_batched(self, entry: PlanCacheEntry, width: int, axes: tuple):
        """The stacked program for an entry at one (width, scan axes)
        layout (the sharded engine builds its lanes-x-shards form)."""
        return ex.compile_plan_batched(entry.compiled.plan, width, axes)

    # -- explain -----------------------------------------------------------
    def _explain_program(
        self, pq: PreparedQuery, prog: _Program, analyze: bool = False
    ) -> str:
        """Human-readable plan report: the logical algebra, the optimizer's
        pass-by-pass rewrite trace, the physical scan/join structure with
        estimated rows and pow-2 buckets, and the plan-cache state for
        this shape — all host-side (no device work). With `analyze`, the
        last run's per-join actuals (captured from the exact totals every
        dispatch returns) are appended beside the estimates."""
        est = self.store.estimate_cardinality
        lines = ["PreparedQuery", "logical algebra:"]
        lines.append(algebra.format_algebra(pq.query.algebra(), 1))
        lines.append(
            "optimizer trace (parse -> algebra -> optimize -> plan):"
        )
        for t in prog.plan.trace:
            lines.append(f"  {t}")
        lines.append("physical plan (scan order -> operator tree):")
        schemas: list[tuple[str, ...]] = []
        caps: list[int] = []
        n_req = len(prog.cross_flags) + 1 if prog.has_required else 0
        n_opt = sum(g.n_scans for g in prog.opt_groups)
        for i, tp in enumerate(prog.patterns):
            schema, _ = self.store.pattern_scan_info(tp)
            schemas.append(schema)
            caps.append(self.store.scan_capacity(tp))
            if i < n_req:
                kind = "required"
            elif i < n_req + n_opt:
                kind = "optional"
            else:
                kind = "union"
            lines.append(
                f"  scan[{i}] ({tp.s} {tp.p} {tp.o}) "
                f"est_rows={est(tp)} bucket={caps[-1]} [{kind}]"
            )
        rename = plan_ir.canonical_renaming(tuple(schemas))
        shape = self._shape_for(prog, tuple(schemas), tuple(caps), rename)
        ests = prog.plan.join_ests
        backends = shape.join_backends
        ji = 0

        def est_str() -> str:
            nonlocal ji
            out = (
                f" est_rows={int(ests[ji])}" if ji < len(ests) else ""
            )
            ji += 1
            return out

        def bk() -> str:
            """Physical algebra of the CURRENT join slot (pre-est_str)."""
            if ji < len(backends) and backends[ji] == "matrix":
                return "matrix_join"
            return "mr_join"

        for i, is_cross in enumerate(shape.cross_flags):
            kind = "cross_join" if is_cross else bk()
            lines.append(f"  join[{i}] {kind}{est_str()}")
        for gi, g in enumerate(shape.opt_groups):
            for _ in g.cross_flags:
                est_str()  # group-internal joins ride in the group line
            kind = bk()
            lines.append(
                f"  left_join[{gi}] ({kind}) OPTIONAL group of {g.n_scans} "
                f"pattern(s), unmatched rows padded UNBOUND,"
                f" inner{est_str()}"
            )
        for bi, g in enumerate(shape.union_groups):
            for _ in g.cross_flags:
                est_str()
            kind = bk()
            tail = est_str() if prog.has_required else ""
            lines.append(
                f"  union_branch[{bi}] {g.n_scans} pattern(s)"
                + (
                    f", joined with required chain ({kind}),{tail}"
                    if tail
                    else ""
                )
            )
        if shape.union_groups:
            lines.append(
                f"  union: concat {len(shape.union_groups)} branch(es), "
                "unbound columns padded UNBOUND"
            )
        for stage, expr in prog.plan.filters:
            lines.append(
                f"  filter: {expr} @ {optimizer._fmt_stage(stage)} "
                "(device-side mask)"
            )
        if shape.has_slice:
            q = pq.query
            limit = "-" if q.limit is None else q.limit
            lines.append(f"  slice: offset={q.offset} limit={limit}")
        entry = self.plan_cache.get(shape)
        if entry is None:
            lines.append(
                "cache: shape not compiled yet (first run calibrates "
                "buckets from exact counts, then compiles)"
            )
        else:
            lines.append(
                f"cache: compiled, join buckets={entry.join_caps}, "
                f"max_capacity={entry.compiled.plan.max_capacity()}"
            )
        lines.append(
            f"plan-cache: {len(self.plan_cache)} entries, "
            f"hit_rate={self.plan_cache.hit_rate:.0%}"
        )
        stale = pq.planned_version != self.store.version
        lines.append(
            f"store: version={self.store.version}, planned against "
            f"v{pq.planned_version}"
            + (
                " (stale: refresh() re-plans on current statistics; "
                "runs are snapshot-consistent either way)"
                if stale
                else ""
            )
        )
        lines.append(
            f"handle: {pq.n_runs} run(s)"
            + (
                f", last run: {pq.last_stats.n_dispatches} dispatch(es), "
                f"{pq.last_stats.n_compiles} compile(s)"
                if pq.last_stats
                else ""
            )
        )
        if analyze:
            lines.extend(self._analyze_lines(pq, prog, shape))
        return "\n".join(lines)

    # -- EXPLAIN ANALYZE ---------------------------------------------------
    def _join_slot_labels(
        self, shape: plan_ir.PlanShape, st: ExecStats
    ) -> list[str]:
        """Physical operator label per join slot, in the evaluation
        (totals) order — recovered from the plan tree by the same
        traversal the lowering uses, so labels line up with actuals."""
        n = len(st.join_totals)
        caps = st.join_caps if len(st.join_caps) == n else (0,) * n
        try:
            plan = plan_ir.build_plan(shape, tuple(caps))
            nodes = ex.join_slot_nodes(plan)
        except Exception:
            nodes = []
        labels = []
        for i in range(n):
            if i < len(nodes):
                node = nodes[i]
                kind = {
                    plan_ir.MRJoin: "mr_join",
                    plan_ir.MatrixJoin: "matrix_join",
                    plan_ir.CrossJoin: "cross_join",
                }.get(type(node))
                if kind is None and isinstance(node, plan_ir.LeftJoin):
                    kind = f"left_join[{node.backend}]"
                labels.append(kind or type(node).__name__.lower())
            else:
                labels.append("join")
        return labels

    def _analyze_slot_extra(self, st: ExecStats, i: int) -> str:
        """Per-slot suffix hook (the sharded engine adds worst-shard rows
        here)."""
        return ""

    def _analyze_tail(self, st: ExecStats) -> list[str]:
        """Run-summary hook after the per-slot lines."""
        return []

    def _analyze_lines(
        self, pq: PreparedQuery, prog: _Program, shape: plan_ir.PlanShape
    ) -> list[str]:
        st = pq.last_stats
        lines = ["EXPLAIN ANALYZE (last run):"]
        if st is None:
            lines.append("  no recorded run — execute the query first")
            return lines
        ests = prog.plan.join_ests
        if st.join_totals:
            labels = self._join_slot_labels(shape, st)
            for i, actual in enumerate(st.join_totals):
                est_v = int(ests[i]) if i < len(ests) else 0
                parts = [
                    f"  join[{i}] {labels[i]}",
                    f"est_rows={est_v}",
                    f"actual_rows={actual}",
                    f"q_error={optimizer.q_error(est_v, actual):.2f}",
                ]
                if i < len(st.join_caps):
                    cap = st.join_caps[i]
                    worst = (
                        st.join_worst[i]
                        if i < len(st.join_worst) else actual
                    )
                    parts.append(f"cap={cap}")
                    parts.append(
                        f"fill={worst / cap:.0%}" if cap else "fill=-"
                    )
                if i < len(st.join_overflows) and st.join_overflows[i]:
                    parts.append(f"overflows={st.join_overflows[i]}")
                lines.append(
                    " ".join(parts) + self._analyze_slot_extra(st, i)
                )
        elif st.n_joins:
            lines.append(
                "  actuals not captured for the last run "
                "(pre-observability execution path)"
            )
        else:
            lines.append("  no join nodes in this plan")
        lines.extend(self._analyze_tail(st))
        rows = st.rows_emitted if st.rows_emitted >= 0 else "-"
        lines.append(
            f"  run: {st.n_dispatches} dispatch(es), "
            f"{st.n_compiles} compile(s), {st.n_retries} retried, "
            f"device_time={st.device_time_s * 1e3:.2f}ms, "
            f"rows_emitted={rows}, store_version={st.store_version}"
        )
        return lines



class LockstepError(RuntimeError):
    """A follower rank found that it no longer makes rank 0's calls."""


class _ShardAcct(NamedTuple):
    """A sharded dispatch's accounting on the host, shard (and lane) axes
    leading, slot last: exact join totals, join overflow flags, exact
    shuffle loads and shuffle overflow flags."""

    totals: np.ndarray
    flags: np.ndarray
    needs: np.ndarray
    sh_flags: np.ndarray

    @classmethod
    def fetch(cls, res, mesh: "dj.ShardMesh") -> "_ShardAcct":
        """Everything in ONE device->host copy: the dispatch's single
        host sync. The program's accounting holds this process's shards;
        across ranks one all_gather of the packed accounting first, so
        every rank sees every shard's totals and flags."""
        n_j = res.totals.shape[-1]
        n_s = res.shuffle_needs.shape[-1]
        packed = torch.cat(
            [res.totals, res.overflows.to(torch.int32),
             res.shuffle_needs, res.shuffle_flags.to(torch.int32)], -1,
        )
        k = packed.shape[-1]
        packed = dj.gather_shards(
            packed.reshape(packed.shape[:-1].numel(), k), mesh
        ).reshape(*packed.shape[:-2], mesh.n_shards, k).cpu().numpy()
        cut = np.cumsum([n_j, n_j, n_s])
        totals, flags, needs, sh_flags = np.split(packed, cut, axis=-1)
        return cls(totals, flags.astype(bool), needs, sh_flags.astype(bool))

    def overflowed(self) -> bool:
        return bool(self.flags.any() or self.sh_flags.any())

    def worst(self) -> "tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]":
        """Per slot over every shard (and lane): (max total, any flag, max
        load, any shuffle flag)."""
        def rows(x: np.ndarray) -> np.ndarray:
            return x.reshape(int(np.prod(x.shape[:-1])), x.shape[-1])

        return (rows(self.totals).max(0, initial=0),
                rows(self.flags).any(0),
                rows(self.needs).max(0, initial=0),
                rows(self.sh_flags).any(0))


@dataclasses.dataclass
class ShardedQueryEngine(QueryEngine):
    """Distributed MapSQ: the same engine over a subject-hash sharded store.

    `store` must be a sparql.sharded_store.ShardedTripleStore whose shard
    count equals the mesh size. Parsing, the algebra, the cost-based
    optimizer, the plan IR and the plan/compile cache are the single-device
    layers UNCHANGED; only three things differ:

      * scans come up as flat per-shard partitions (upload-once per shard)
        and the PlanShape's scan/join capacities are PER-SHARD buckets;
      * the program is core/dist_executor.py's one sharded dispatch —
        PARTITIONING-AWARE: a join input already hash-partitioned on the
        join key (subject-variable scans start that way) joins map-side
        with NO exchange, a small misaligned side is broadcast
        (all_gather) instead of shuffling both, and only genuinely
        misaligned sides pay the hash shuffle;
      * overflow handling grows the worst SHARD's flagged bucket (join or
        shuffle — per mesh-axis stage) from the exact numbers that ride
        back with the dispatch, recompiles, and retries — the
        single-device discipline per shard.

    Where the shards live is the caller's choice:

      * `ranks=None`: every shard on the engine's one device, along an
        explicit shard axis (core/distributed.py); `mesh=None` builds one
        axis `axis_name` of `store.n_shards` shards;
      * `ranks=init_ranks(...)` (core/ranks.py): one shard per process,
        the reference's one shard per device. The mesh is the ranks'
        (`mesh=None`: one axis of every rank), the store's shard count
        must equal the world size, each rank stages its own shard's scans
        and the exchanges are `torch.distributed` collectives. Rank 0
        leads: each public call (PreparedQuery.run, execute, run_batch*,
        update, save_cache) is first sent to the other ranks, which run
        `follow()` and make the same call, until rank 0's `close()`.
        Only rank 0 decodes rows; every rank returns the same arrays,
        equal to the one-process engine's.

    Warm queries are exactly one dispatch and zero compiles, same as the
    base engine.
    """

    mesh: "dj.ShardMesh | None" = None
    axis_name: str = "shards"
    ranks: "RankContext | None" = None

    def __post_init__(self):
        from repro_torch.sparql.sharded_store import ShardedTripleStore

        if not isinstance(self.store, ShardedTripleStore):
            raise TypeError(
                "ShardedQueryEngine needs a ShardedTripleStore "
                f"(got {type(self.store).__name__}); wrap a TripleStore "
                "with sparql.sharded_store.shard_store(store, n_shards)"
            )
        if self.ranks is not None:
            self._take_ranks()
        if self.mesh is None:
            self.mesh = dj.make_mesh((self.store.n_shards,), (self.axis_name,))
        self.axis_names = tuple(self.mesh.axis_names)
        self.n_shards = self.mesh.n_shards
        if self.store.n_shards != self.n_shards:
            raise ValueError(
                f"store has {self.store.n_shards} shards but the mesh has "
                f"{self.n_shards}"
            )
        if not self.compiled:
            raise ValueError(
                "sharded execution is compiled-only (compiled=True)"
            )
        super().__post_init__()
        # cross-shape padded stacking is single-device only: near-miss
        # shapes stay per-shape groups here
        self.pad_stacking = False
        # this rank's own shard (None: every shard here), and lockstep:
        # one thread at a time sends a call and makes it (see _leading)
        self._own_shard = None if self.ranks is None else self.ranks.rank
        self._lead_lock = threading.RLock()
        self._lead_depth = 0
        self._following = False
        # shuffle bucket signatures persisted by a previous process (the
        # sharded extension of the warmup file)
        self._warm_shuffle: dict[plan_ir.PlanShape, tuple[int, ...]] = {}
        if self.warmup_path is not None:
            p = pathlib.Path(self.warmup_path)
            if p.exists():
                for e in json.loads(p.read_text())["entries"]:
                    sh = tuple(int(c) for c in e.get("shuffle_caps", ()))
                    if sh:
                        shape = plan_ir.shape_from_jsonable(e["shape"])
                        self._warm_shuffle[shape] = sh

    def _take_ranks(self) -> None:
        """One shard per rank: the ranks' mesh and device."""
        mesh = self.ranks.mesh
        if self.mesh is not None and self.mesh != mesh:
            raise ValueError(
                f"mesh {self.mesh.axis_sizes} is not the ranks' mesh "
                f"{mesh.axis_sizes}"
            )
        self.mesh = mesh
        dev = self.ranks.device
        if self.device is not None:
            asked = torch.device(self.device)
            if asked.type != dev.type or asked.index not in (None, dev.index):
                raise ValueError(f"device {asked} is not this rank's {dev}")
        self.device = dev

    # -- lockstep across ranks ---------------------------------------------
    def _leading(self, method: str, arg):
        if self.ranks is None:
            return contextlib.nullcontext()
        return self._lead(method, arg)

    @contextlib.contextmanager
    def _lead(self, method: str, arg):
        """Rank 0 sends the call to every follower before making it (a
        nested public call is part of the outer one and sends nothing).
        Prepared queries travel as (text, program): a follower runs rank
        0's plan, whatever the store's statistics were when it was made."""
        if self.ranks.rank != 0 and not self._following:
            raise RuntimeError(
                f"rank {self.ranks.rank} follows rank 0's calls: run "
                "engine.follow() there"
            )
        with self._lead_lock:
            if self._lead_depth == 0 and not self._following:
                if method in ("run", "run_batch"):
                    arg = [(pq.text, pq._program) for pq in arg]
                self.ranks.broadcast((method, arg))
            self._lead_depth += 1
            try:
                yield
            finally:
                self._lead_depth -= 1

    def follow(self, on_call=None) -> int:
        """A follower rank's loop: receive rank 0's calls in order and make
        each one, until rank 0's close(). A call that fails here failed
        on rank 0 too, at the same point (every host decision runs on the
        same gathered numbers), so the loop goes on, as rank 0's caller
        does. `on_call(method, outcome)` sees each call's outcome: its
        runs' ExecStats (a list), an UpdateResult, None, or the exception
        raised. Returns the number of calls made."""
        if self.ranks is None or self.ranks.rank == 0:
            raise RuntimeError("only a rank other than 0 follows")
        n = 0
        self._following = True
        try:
            while True:
                method, arg = self.ranks.broadcast()
                if method == "close":
                    return n
                n += 1
                try:
                    outcome = self._follow_call(method, arg)
                except LockstepError:
                    raise
                except Exception as e:  # rank 0 raised it to its caller
                    log.info("rank %d: %s failed as on rank 0: %r",
                             self.ranks.rank, method, e)
                    outcome = e
                if on_call is not None:
                    on_call(method, outcome)
        finally:
            self._following = False

    def _follow_call(self, method: str, arg):
        def mirror(text: str, prog: _Program) -> PreparedQuery:
            return PreparedQuery(self, text, prog.query, program=prog)

        if method == "run":
            ((text, prog),) = arg
            return [mirror(text, prog)._run_pending().stats]  # no decode
        if method == "run_batch":
            outs = self._run_batch_impl([mirror(*a) for a in arg], defer=True)
            return [o if isinstance(o, Exception) else o.stats for o in outs]
        if method == "execute":
            stats = ExecStats()
            self._execute_program(arg, stats)
            return [stats]
        if method == "update":
            return self.update(arg)
        if method == "save_cache":
            # rank 0 writes the file; the same cache here, or the ranks
            # have left lockstep
            mine = [self._entry_jsonable(e) for e in self.plan_cache.entries()]
            if mine != arg:
                raise LockstepError(
                    f"rank {self.ranks.rank}'s plan cache differs from "
                    "rank 0's"
                )
            return None
        raise LockstepError(f"unknown call {method!r}")

    def close(self) -> None:
        """Rank 0: end the followers' loops (its last call). Nothing to do
        with every shard in this process."""
        if self.ranks is not None and self.ranks.rank == 0:
            with self._lead_lock:
                self.ranks.broadcast(("close", None))

    # -- planning ----------------------------------------------------------
    def _scan_caps(
        self, scans: tuple[Relation, ...]
    ) -> tuple[int, ...]:
        """Capacities entering the PlanShape are the PER-SHARD row
        buckets (the flat scan buffer holds local_shards equal blocks,
        so its per-shard slice is capacity // local_shards)."""
        return tuple(s.capacity // self.mesh.local_shards for s in scans)

    def _device_scan(self, tp: TriplePattern) -> Relation:
        return self.store.match_pattern_device(
            tp, self.device, self._own_shard
        )

    def _all_shards(self, rel: Relation) -> Relation:
        """A scan's every shard block, flat in shard order: the staged
        buffer itself in one process, all-gathered across ranks."""
        if self.ranks is None:
            return rel
        g = dj.gather_relation(
            Relation(rel.schema, rel.cols[None], rel.valid[None]), self.mesh
        )
        return Relation(rel.schema, g.cols[0], g.valid[0])

    def _scan_parts(
        self,
        prog: _Program,
        schemas: tuple[tuple[str, ...], ...],
    ) -> tuple[int, ...]:
        """The store shards rows by subject hash — the SAME FNV-1a route
        the shuffle uses — so a subject-VARIABLE scan arrives already
        hash-partitioned on that column; the lowering elides every
        shuffle this placement satisfies. A constant subject pins all
        matches to one shard (not a hash placement of any variable)."""
        return tuple(
            schema.index(tp.s) if tp.s.startswith("?") else -1
            for tp, schema in zip(prog.patterns, schemas)
        )

    def _caps_from_totals(self, totals: list[int]) -> tuple[int, ...]:
        """Per-shard join buckets from the calibration run's exact GLOBAL
        totals: the uniform-hash share, pow-2 bucketed. Key skew shows up
        as an overflow on the first dispatch and regrows from the worst
        shard's exact total."""
        return tuple(
            plan_ir.bucket_capacity(max(1, -(-int(t) // self.n_shards)))
            for t in totals
        )

    # -- compiled path -----------------------------------------------------
    def _compiled_cold(
        self,
        shape: plan_ir.PlanShape,
        canon_scans: tuple[Relation, ...],
        prog: _Program,
        stats: ExecStats,
        trace=None,
    ) -> Relation:
        """Cache miss: calibrate GLOBAL join totals with the eager
        evaluator (the flat scan buffer is a valid single-device relation,
        so the count passes are exact), size per-shard buckets at the
        uniform-hash share, then DISPATCH once — unlike the base engine,
        the cold query is served by the sharded program, so any hash-skew
        overflow regrows now and warm queries stay at one dispatch, zero
        compiles."""
        stats.cache_misses += 1
        self.plan_cache.misses += 1
        join_caps = self._warm_caps.get(shape)
        if join_caps is None or len(join_caps) != shape.n_joins():
            eager_stats = ExecStats()
            t0 = time.perf_counter()
            # every rank calibrates on every shard's rows
            _, totals = self._eval_shape_eager(
                shape, tuple(self._all_shards(s) for s in canon_scans), prog,
                eager_stats,
            )
            if trace is not None:
                trace.add_span(
                    "dispatch", t0, time.perf_counter(), calibration=True
                )
            stats.n_count_passes += eager_stats.n_count_passes
            stats.n_dispatches += eager_stats.n_dispatches
            stats.n_retries += eager_stats.n_retries
            stats.device_time_s += eager_stats.device_time_s
            join_caps = self._caps_from_totals(totals)
        entry = self._compile_entry(
            shape, join_caps, stats, trace=trace, precompile=True
        )
        return self._dispatch_entry(
            shape, entry, canon_scans, *self._device_consts(prog), stats,
            trace,
        )

    def _compile(self, shape, join_caps, shuffle_caps):
        """The sharded program at (shape, join caps) and one shuffle bucket
        per site per mesh-axis stage: the given ones, else the cached
        entry's, else a previous process's, else the uniform estimate."""
        from repro_torch.core import dist_executor as dx

        plan = plan_ir.build_plan(shape, join_caps)
        n_slots = dx.n_shuffle_slots(plan, len(self.axis_names))
        if shuffle_caps is None:
            prev = self.plan_cache.get(shape)
            if prev is not None and len(
                prev.compiled.shuffle_caps
            ) == n_slots:
                shuffle_caps = prev.compiled.shuffle_caps
            else:
                shuffle_caps = self._warm_shuffle.get(shape)
        if shuffle_caps is None or len(shuffle_caps) != n_slots:
            shuffle_caps = dx.initial_shuffle_caps(
                plan, self.mesh.axis_sizes
            )
        return dx.compile_sharded_plan(plan, self.mesh, shuffle_caps)

    def _build_batched(self, entry: PlanCacheEntry, width: int, axes: tuple):
        from repro_torch.core import dist_executor as dx

        return dx.compile_sharded_plan_batched(
            entry.compiled.plan, self.mesh, entry.compiled.shuffle_caps,
            width, axes,
        )

    def _regrow(
        self,
        shape: plan_ir.PlanShape,
        entry: PlanCacheEntry,
        acct: _ShardAcct,
        ovf_counts: list[int],
        stats: ExecStats,
        trace=None,
    ) -> PlanCacheEntry:
        """A bucket overflowed on some shard: grow the flagged join and
        shuffle buckets to the worst shard's exact numbers and recompile."""
        stats.n_retries += 1
        totals, flags, needs, sh_flags = acct.worst()
        for j, f in enumerate(flags):
            ovf_counts[j] += int(f)
        new_caps = plan_ir.grow_join_caps(
            entry.join_caps, [int(t) for t in totals], list(flags)
        )
        new_shuffle = plan_ir.grow_join_caps(
            entry.compiled.shuffle_caps, [int(n) for n in needs],
            list(sh_flags),
        )
        if max(new_caps + new_shuffle) > self.max_capacity:
            raise MemoryError(f"join result exceeds {self.max_capacity}")
        return self._compile_entry(
            shape, new_caps, stats, trace=trace, shuffle_caps=new_shuffle
        )

    def _dispatch_entry(
        self,
        shape: plan_ir.PlanShape,
        entry: PlanCacheEntry,
        canon_scans: tuple[Relation, ...],
        consts_i: torch.Tensor,
        consts_f: torch.Tensor,
        num_vals: torch.Tensor,
        stats: ExecStats,
        trace=None,
    ) -> Relation:
        ovf_counts = [0] * shape.n_joins()
        while True:
            stats.n_dispatches += 1
            self._count_shuffles(entry, stats)
            t0 = time.perf_counter()
            res, enq = _enqueue(
                trace is not None, entry.compiled,
                canon_scans, consts_i, consts_f, num_vals,
            )
            caps = entry.compiled.plan.join_caps
            stats.peak_capacity = max(
                stats.peak_capacity, entry.compiled.plan.max_capacity()
            )
            stats.peak_join_bucket = max(
                stats.peak_join_bucket, max(caps) if caps else 0
            )
            acct = _ShardAcct.fetch(res, self.mesh)
            t1 = self._device_tick(stats, t0)
            if trace is not None:
                _add_event(trace, "dispatch", t0, t1, enq,
                           n_shards=self.n_shards)
            if not acct.overflowed():
                # totals are (n_shards, n_joins): the analyze view wants
                # the global rows AND the worst shard (fill pressure is a
                # per-shard property under hash skew)
                stats.join_totals = tuple(
                    int(x) for x in acct.totals.sum(axis=0)
                )
                stats.join_worst = tuple(
                    int(x) for x in acct.totals.max(axis=0, initial=0)
                )
                stats.join_caps = tuple(caps)
                stats.join_overflows = tuple(ovf_counts)
                stats.shuffle_loads = tuple(int(x) for x in acct.worst()[2])
                return res.relation
            entry = self._regrow(shape, entry, acct, ovf_counts, stats, trace)

    def _count_shuffles(self, entry: PlanCacheEntry, stats: ExecStats):
        """Fold the program's static data-movement choices into the run's
        stats, once per sharded dispatch."""
        from repro_torch.core import dist_executor as dx

        cnt = dx.strategy_counts(entry.compiled.strategies)
        stats.n_shuffles_emitted += cnt["emitted"]
        stats.n_shuffles_elided += cnt["elided"]
        stats.n_broadcast_joins += cnt["broadcast"]

    # -- batching ----------------------------------------------------------
    def _stage_chunk(
        self, shape: plan_ir.PlanShape, lanes: list[_BatchCtx], n: int
    ) -> _ChunkInputs:
        """The device inputs of one stacked sharded dispatch: per scan
        position, an identical pattern across lanes ships its flat
        (n_shards * cap) buffer once (axis None); else a stacked (width,
        n_shards * cap) buffer (axis 0)."""
        scans: list[Relation] = []
        axes: list[int | None] = []
        with self.store.snapshot_lock():  # one store version per chunk
            for j, schema in enumerate(shape.scan_schemas):
                tps = tuple(c.prog.patterns[j] for c in lanes)
                if len({self.store._scan_key(tp) for tp in tps}) == 1:
                    rel = self._device_scan(tps[0])
                    scans.append(Relation(schema, rel.cols, rel.valid))
                    axes.append(None)
                else:
                    scans.append(Relation(
                        schema,
                        *self.store.stacked_scan_device(
                            tps, self.device, self._own_shard
                        ),
                    ))
                    axes.append(0)
            version = self.store.version
        return _ChunkInputs(
            tuple(scans),
            tuple(axes),
            torch.from_numpy(
                np.stack([c.prog.consts_i for c in lanes])
            ).to(self.device),
            torch.from_numpy(
                np.stack([c.prog.consts_f for c in lanes])
            ).to(self.device),
            self.store.numeric_values_device(self.device),
            torch.from_numpy(np.arange(len(lanes)) < n).to(self.device),
            version,
        )

    def _run_chunk_stacked(
        self,
        shape: plan_ir.PlanShape,
        chunk: list[int],
        ctxs: list["_BatchCtx | None"],
        prepared: list[PreparedQuery],
        out: list,
        group: BatchGroupStats,
        defer: bool = False,
        traces: "list | None" = None,
    ) -> None:
        """ONE stacked sharded dispatch (lanes x shards) for a chunk of
        warm same-shape queries — the distributed mirror of the base
        engine's stacked path. Grouping, chunking, deferred decode and
        the MemoryError fallback are the inherited run_batch machinery
        (cross-shape padding is off here, so `shape` is always every
        lane's natural signature)."""
        entry = self.plan_cache.get(shape)
        n = len(chunk)
        width = plan_ir.bucket_width(n, self.max_batch_width)
        lanes = [ctxs[i] for i in chunk] + [ctxs[chunk[0]]] * (width - n)
        inp = self._stage_chunk(shape, lanes, n)
        group.n_broadcast_scans += sum(1 for a in inp.scan_axes if a is None)
        stats = ExecStats(
            n_joins=shape.n_joins(),
            cache_hits=1,
            batch_width=width,
            store_version=inp.store_version,
        )
        self.plan_cache.hits += n
        events: list[tuple[str, float, float, "tuple | None"]] = []
        traced = any(traces[i] is not None for i in chunk) if traces else False
        ovf_counts = [0] * shape.n_joins()
        try:
            while True:
                bexec = entry.batched.get((width, inp.scan_axes))
                if bexec is None:
                    tc0 = time.perf_counter()
                    bexec = self._build_batched(entry, width, inp.scan_axes)
                    events.append(
                        ("compile", tc0, time.perf_counter(), None)
                    )
                    entry.batched[(width, inp.scan_axes)] = bexec
                    stats.n_compiles += 1
                    self.plan_cache.compiles += 1
                stats.n_dispatches += 1
                self._count_shuffles(entry, stats)
                t0 = time.perf_counter()
                res, enq = _enqueue(
                    traced, bexec, inp.scans, inp.consts_i, inp.consts_f,
                    inp.num_vals, inp.active,
                )
                acct = _ShardAcct.fetch(res, self.mesh)  # every (lane, shard)
                events.append(
                    ("dispatch", t0, self._device_tick(stats, t0), enq)
                )
                if not acct.overflowed():
                    break
                entry = self._regrow(shape, entry, acct, ovf_counts, stats)
        finally:
            group.n_dispatches += stats.n_dispatches
            group.n_compiles += stats.n_compiles
        group.widths = group.widths + (width,)
        self.stacked_dispatches += stats.n_dispatches
        self.batch_width_hist[width] = (
            self.batch_width_hist.get(width, 0) + stats.n_dispatches
        )
        self.stacked_queries += n
        caps = entry.compiled.plan.join_caps
        stats.peak_join_bucket = max(caps) if caps else 0
        stats.peak_capacity = entry.compiled.plan.max_capacity()
        stats.join_caps = tuple(caps)
        stats.join_overflows = tuple(ovf_counts)
        stats.shuffle_loads = tuple(int(x) for x in acct.worst()[2])
        # (width, n_shards, n_joins): per-lane global rows sum over
        # shards, fill pressure is the worst shard
        lane_totals = (acct.totals.sum(axis=1),
                       acct.totals.max(axis=1, initial=0))
        self._emit_chunk_results(
            res.relation, chunk, ctxs, prepared, out, stats, defer,
            lane_totals, traces=traces, events=events,
        )

    # -- persistence -------------------------------------------------------
    def _entry_jsonable(self, e: PlanCacheEntry) -> dict:
        """Base signature plus the entry's shuffle bucket caps, so a
        restarted sharded server compiles warm shapes with zero
        shuffle-overflow retries too."""
        d = super()._entry_jsonable(e)
        d["shuffle_caps"] = list(e.compiled.shuffle_caps)
        return d

    # -- explain -----------------------------------------------------------
    def _analyze_slot_extra(self, st: ExecStats, i: int) -> str:
        if i < len(st.join_worst):
            return f" worst_shard_rows={st.join_worst[i]}"
        return ""

    def _analyze_tail(self, st: ExecStats) -> list[str]:
        lines = []
        if st.shuffle_loads:
            lines.append(
                "  shuffle slots worst-shard rows="
                f"{list(st.shuffle_loads)}"
            )
        lines.append(
            f"  data movement: {st.n_shuffles_emitted} shuffle(s) "
            f"emitted, {st.n_shuffles_elided} elided, "
            f"{st.n_broadcast_joins} broadcast join(s)"
        )
        return lines

    def _explain_program(
        self, pq: PreparedQuery, prog: _Program, analyze: bool = False
    ) -> str:
        from repro_torch.core import dist_executor as dx

        lines = [super()._explain_program(pq, prog, analyze=analyze)]
        lines.append(
            f"sharded: {self.n_shards} shard(s), mesh axes "
            f"{list(self.axis_names)}, subject-hash partitioned scans"
        )
        schemas: list[tuple[str, ...]] = []
        caps: list[int] = []
        for i, tp in enumerate(prog.patterns):
            counts = self.store.per_shard_counts(tp)
            schema, _ = self.store.pattern_scan_info(tp)
            schemas.append(schema)
            caps.append(self.store.scan_capacity(tp))
            lines.append(
                f"  scan[{i}] per-shard rows={counts} "
                f"per-shard bucket={caps[-1]}"
            )
        rename = plan_ir.canonical_renaming(tuple(schemas))
        shape = self._shape_for(prog, tuple(schemas), tuple(caps), rename)
        entry = self.plan_cache.get(shape)
        if entry is not None:
            lines.append(
                f"  per-shard join buckets={entry.join_caps}, "
                f"shuffle buckets={entry.compiled.shuffle_caps}"
            )
            strategies = entry.compiled.strategies
        else:
            # not compiled yet: derive the strategies the lowering WILL
            # choose (pure static analysis over the would-be plan)
            plan = plan_ir.build_plan(
                shape, (plan_ir.MIN_BUCKET,) * shape.n_joins()
            )
            strategies = dx.analyze_plan(plan, self.n_shards)
        for i, st in enumerate(strategies):
            lines.append(f"  shuffle[{i}] {st.op}: {dx.format_strategy(st)}")
        cnt = dx.strategy_counts(strategies)
        lines.append(
            f"  shuffles: {cnt['emitted']} emitted, {cnt['elided']} "
            f"elided, {cnt['broadcast']} broadcast join(s)"
        )
        return "\n".join(lines)
