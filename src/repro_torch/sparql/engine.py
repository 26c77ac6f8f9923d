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
      exactly-sized (next-pow2) buffer, EXPAND pass.

The engine runs on the card unless it is given device="cpu"; the store
stages its scans on the engine's device.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch import resolve_device
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
    # the store version this run's scans were staged at (-1 = not set):
    # the snapshot the results are consistent with
    store_version: int = -1
    # host wall seconds spent inside device dispatch + result sync for
    # THIS run (the engine-level `device_time_s` is the sum of these)
    device_time_s: float = 0.0
    # rows this run's decode emitted (-1 = not yet decoded)
    rows_emitted: int = -1
    # EXPLAIN ANALYZE actuals, in join-slot (evaluation) order — the same
    # order as plan.join_ests/join_caps. Captured from the exact totals
    # that ride back with every dispatch:
    #   join_totals    matched rows per join slot
    #   join_overflows overflow->regrow events per slot (summed)
    #   join_caps      bucket capacity the final (successful) run used
    join_totals: tuple[int, ...] = ()
    join_overflows: tuple[int, ...] = ()
    join_caps: tuple[int, ...] = ()

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
        self.store_version = max(self.store_version, other.store_version)
        self.device_time_s += other.device_time_s
        if other.rows_emitted >= 0:
            self.rows_emitted = other.rows_emitted
        # actuals: last run wins (pq.stats accumulates across runs but
        # the analyze view reports the most recent execution); overflow
        # events accumulate
        if other.join_totals:
            self.join_totals = other.join_totals
            self.join_caps = other.join_caps
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


class ResultSet:
    """Typed, decoded query result: rows as {var: term} dicts (variables an
    OPTIONAL group left unbound are omitted), plus the producing run's
    ExecStats. Compares equal to a plain list of row dicts for convenience.
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
    """The device→host transfer of one dispatch's result.

    The transfer is LAZY: whichever consumer resolves first pays the
    (single) sync, and the device buffers are dropped immediately after so
    a slow decode never pins device memory longer than one transfer."""

    __slots__ = ("_lock", "_rel", "cols", "valid", "transfer_s")

    def __init__(self, rel: Relation):
        self._lock = threading.Lock()
        self._rel: Relation | None = rel
        self.cols: np.ndarray | None = None
        self.valid: np.ndarray | None = None
        self.transfer_s = 0.0

    def fetch(self) -> tuple[np.ndarray, np.ndarray, bool]:
        """Returns (cols, valid, paid): `paid` is True for the one caller
        that performed the device->host sync, False for sharers."""
        with self._lock:
            if self._rel is not None:
                t0 = time.perf_counter()
                self.cols = self._rel.cols.cpu().numpy()
                self.valid = self._rel.valid.cpu().numpy()
                self.transfer_s = time.perf_counter() - t0
                self._rel = None
                return self.cols, self.valid, True
        return self.cols, self.valid, False


class PendingDecode:
    """A dispatched query's undecoded result: result buffers (device-side
    until the first consumer fetches) plus what is needed to materialise
    rows. `resolve()` is the transfer + row decode + per-handle
    accounting."""

    __slots__ = ("engine", "pq", "vars", "names", "fetch", "stats", "trace")

    def __init__(self, engine: "QueryEngine", pq: "PreparedQuery",
                 vars: tuple[str, ...], names: tuple[str, ...],
                 fetch: _SharedFetch, stats: ExecStats, trace=None):
        self.engine = engine
        self.pq = pq
        self.vars = vars
        self.names = names
        self.fetch = fetch
        self.stats = stats
        self.trace = trace

    def resolve(self) -> ResultSet:
        t0 = time.perf_counter()
        cols, valid, paid = self.fetch.fetch()
        t1 = time.perf_counter()
        rows = self.engine._decode_numpy(self.names, cols[valid])
        t2 = time.perf_counter()
        if self.trace is not None:
            self.trace.add_span("transfer", t0, t1, paid=paid,
                                transfer_s=round(self.fetch.transfer_s, 6))
            self.trace.add_span("decode", t1, t2, rows=len(rows))
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

    def __init__(self, engine: "QueryEngine", text: str, query: Query):
        self.engine = engine
        self.text = text
        self.query = query
        self._program = engine._build_program(query)
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
        self.planned_version = self.engine.store.version
        return True

    def run(self, trace=None) -> ResultSet:
        return self._run_pending(trace).resolve()

    def _run_pending(self, trace=None) -> PendingDecode:
        """Dispatch the query, returning its result as a PendingDecode:
        device work is enqueued, host decode is not yet paid. run() is
        `_run_pending().resolve()`."""
        stats = ExecStats()
        rel = self.engine._execute_program(self._program, stats, trace)
        return PendingDecode(
            self.engine, self, self._program.projection, rel.schema,
            _SharedFetch(rel), stats, trace,
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
    max_capacity: int = 1 << 24
    compiled: bool = True  # one-dispatch compiled pipeline vs eager loop
    plan_cache_entries: int = 256
    # physical join algebra: None = per-node cost-based choice (the
    # optimizer's selectivity x skew rule), "mr" / "matrix" = force every
    # join slot onto that backend (differential tests, benchmarks)
    join_backend: str | None = None
    warmup_path: str | None = None  # saved bucket signatures (save_cache)
    # per-query span tracing: None (default) = off, zero overhead beyond
    # `trace is not None` checks on the dispatch path.
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
        if self.warmup_path is not None:
            p = pathlib.Path(self.warmup_path)
            if p.exists():
                data = json.loads(p.read_text())
                # v3 files carry the writer's statistics catalog: seed the
                # store's lazy cache with it so backend choices (hence plan
                # shapes) match the saved signatures exactly. Older files
                # (v1/v2) have no catalog — the store computes its own,
                # which is identical for the same triples. Stacked-batch
                # widths and layouts in the file are not used here.
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
        # cumulative wall seconds the host spent inside device dispatch +
        # result sync (device idle share = 1 - Δdevice_time_s / wall)
        self.device_time_s = 0.0
        # the unified metrics registry: engine-side counters are bridged
        # in by a scrape-time collector (the dispatch path pays nothing)
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
        """Account one dispatch-and-sync interval on BOTH ledgers (the
        engine-wide total and this run's ExecStats) so the engine total
        always equals the sum over runs. Returns the end stamp."""
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
        Returns the number of signatures written.
        """
        entries = [
            {
                "shape": plan_ir.shape_to_jsonable(e.shape),
                "join_caps": list(e.join_caps),
            }
            for e in self.plan_cache.entries()
        ]
        pathlib.Path(path).write_text(
            json.dumps(
                {
                    "version": 3,
                    # the statistics catalog (incl. per-predicate degree
                    # skew) rides along so a restarted process makes the
                    # SAME backend decisions — shapes keep hashing to the
                    # saved signatures even if it recomputes nothing
                    "statistics": self.store.statistics.to_jsonable(),
                    "entries": entries,
                }
            )
        )
        return len(entries)

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
        rel = self._execute_program(self._build_program(q), stats)
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
        with self.store.snapshot_lock():
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
        plan = optimizer.optimize(q, self.store)
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
            prune=True,
            join_backends=backends,
        )

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
        if trace is not None:
            trace.add_span("dispatch", t0, time.perf_counter(), eager=True)
        return rel

    def _decode_rows(self, rel: Relation) -> list[dict[str, str]]:
        return self._decode_numpy(rel.schema, rel.to_numpy())

    def _decode_numpy(
        self, schema: tuple[str, ...], rows: np.ndarray
    ) -> list[dict[str, str]]:
        d = self.store.dictionary
        return [
            {
                v: d.decode(int(t))
                for v, t in zip(schema, row)
                if int(t) != UNBOUND
            }
            for row in rows
        ]

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
            scans = tuple(
                self.store.match_pattern_device(tp, self.device)
                for tp in prog.patterns
            )
        schemas = tuple(s.schema for s in scans)
        rename = plan_ir.canonical_renaming(schemas)
        inverse = {c: o for o, c in rename.items()}
        canon_scans = tuple(
            Relation(tuple(rename[v] for v in s.schema), s.cols, s.valid)
            for s in scans
        )
        shape = self._shape_for(
            prog, schemas, tuple(s.capacity for s in scans), rename
        )
        return canon_scans, shape, inverse

    def _device_consts(
        self, prog: _Program
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Device placement of the runtime-constant inputs."""
        return (
            torch.from_numpy(prog.consts_i).to(self.device),
            torch.from_numpy(prog.consts_f).to(self.device),
            self.store.numeric_values_device(self.device),
        )

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
            entry = self._compile_entry(shape, warm_caps, stats, trace=trace)
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
        join_caps = tuple(plan_ir.bucket_capacity(t) for t in totals)
        stats.join_totals = tuple(totals)
        stats.join_caps = join_caps
        self._compile_entry(shape, join_caps, stats, trace=trace)
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
            rel, totals, flags = entry.compiled(
                canon_scans, consts_i, consts_f, num_vals
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
                trace.add_span("dispatch", t0, t1)
            if not flags_np.any():
                stats.join_totals = tuple(
                    int(t) for t in totals.cpu().numpy()
                )
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
    ) -> PlanCacheEntry:
        t_compile = time.perf_counter()
        compiled = ex.compile_plan(plan_ir.build_plan(shape, join_caps))
        stats.n_compiles += 1
        self.plan_cache.compiles += 1
        entry = PlanCacheEntry(shape, join_caps, compiled)
        self.plan_cache.put(shape, entry)
        if trace is not None:
            trace.add_span(
                "compile", t_compile, time.perf_counter(),
                n_joins=len(join_caps),
            )
        return entry

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
                    parts.append(f"cap={cap}")
                    parts.append(
                        f"fill={actual / cap:.0%}" if cap else "fill=-"
                    )
                if i < len(st.join_overflows) and st.join_overflows[i]:
                    parts.append(f"overflows={st.join_overflows[i]}")
                lines.append(" ".join(parts))
        elif st.n_joins:
            lines.append(
                "  actuals not captured for the last run "
                "(pre-observability execution path)"
            )
        else:
            lines.append("  no join nodes in this plan")
        rows = st.rows_emitted if st.rows_emitted >= 0 else "-"
        lines.append(
            f"  run: {st.n_dispatches} dispatch(es), "
            f"{st.n_compiles} compile(s), {st.n_retries} retried, "
            f"device_time={st.device_time_s * 1e3:.2f}ms, "
            f"rows_emitted={rows}, store_version={st.store_version}"
        )
        return lines

