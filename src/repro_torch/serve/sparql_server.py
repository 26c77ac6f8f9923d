"""SPARQL serving front-end: the MapSQ framework (Fig 1) as a service.

Requests (query strings) flow through the MicroBatcher; the engine executes
each batch — partial matching per pattern, then the operator tree on
device. Batching amortizes dispatch overhead exactly like the paper's
CPU-assigns / GPU-computes split: each batch is routed through
`engine.run_batch_pipelined`, which coalesces same-shape batchmates into
single stacked (vmapped) device dispatches: N warm identical-shape
requests cost ceil(N / width) launches, not N — and cross-shape padded
stacking merges near-miss plan shapes into those dispatches too. Mixed
batches fall back per plan group; `stats()["batched"]` reports the
batch-width histogram, queries-per-dispatch and the padding ledger so
operators can watch the coalescing win.

The hot path is a TWO-STAGE pipeline. The batcher thread only groups and
dispatches: each request's host decode (device→host transfer + row
materialisation) comes back as a PendingDecode and is handed to a bounded
`DecodePool` (serve/decode.py) of DECODE_WORKERS threads, so dispatch of
batch k+1 overlaps decode of batch k and per-request futures resolve from
the decode side. Per-request wall-clock deadlines
(`query(text, timeout_ms=...)`) raise QueryTimeoutError and mark the
request abandoned so the decode stage skips work nobody will read.

Responses are typed: a successful request yields a `QueryResult` (which
still compares/iterates like the plain row list for back-compat), a failed
one raises a `QueryError` on the caller's thread — parse failures raise
`ParseQueryError`, which is also a `ParseError`. Raw `Exception` objects
never travel inside result lists.

All requests in all batches share one QueryEngine and therefore ONE plan/
compile cache and one device scan cache — plus a server-side cache of
`PreparedQuery` handles keyed by query text, so repeated queries skip
parsing and planning entirely. The first request of a given query shape
pays calibration + compilation, every later request (from any client) is a
cache hit dispatching a single precompiled device program. `stats()`
reports the cache hit rates so operators can watch the warm fraction.

The store is live: `update(text)` applies `INSERT DATA` / `DELETE DATA`
requests through the delta-block write path. Cached prepared handles stay
valid across updates — each run re-stages its scans at the store's current
version, so warm plan shapes keep dispatching precompiled programs as long
as writes stay within their capacity buckets. `stats()["store"]` and
`stats()["updates"]` report store version, tail/tombstone sizes, and the
server's cumulative write counters.

Observability: when the engine carries a `Tracer`, every request gets a
per-query trace — parse, optimize, compile, dispatch (fanned across
stacked lanes), transfer and decode spans — finished (and ring-buffered)
in `query()`'s finally, the ONLY closer, so no path leaks an open span.
Request counters live on the engine's `MetricsRegistry`
(`render_prometheus()` is a single scrape covering server + engine), and
every request is counted under exactly ONE terminal outcome
(ok/timeout/error) at this submitter site — a timed-out request whose
decode later completes is a timeout, full stop, never also an "ok".
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict

from repro_torch.serve.batcher import BatchTimeout, Deferred, MicroBatcher
from repro_torch.serve.decode import DecodePool
from repro_torch.sparql.engine import (
    PendingDecode,
    PreparedQuery,
    QueryEngine,
    UpdateResult,
)
from repro_torch.sparql.parser import ParseError

DECODE_WORKERS = 2  # decode-pool threads resolving PendingDecode slots
DECODE_QUEUE = 64  # backpressure bound on undecoded results


@dataclasses.dataclass
class QueryResult:
    """Successful response envelope: decoded rows + result metadata.

    Sequence-compatible with the historical `list[dict]` return shape:
    len/iter/index/== all defer to `rows`.
    """

    rows: list[dict[str, str]]
    vars: tuple[str, ...]
    from_cache: bool  # served via a cached PreparedQuery handle

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self):
        return iter(self.rows)

    def __getitem__(self, i):
        return self.rows[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, QueryResult):
            return self.rows == other.rows
        if isinstance(other, list):
            return self.rows == other
        return NotImplemented


class QueryError(Exception):
    """Typed failure envelope: what failed (parse/plan/execution) and for
    which query. Raised on the submitting caller's thread, never returned
    inside a result list."""

    def __init__(self, kind: str, message: str, query: str):
        super().__init__(message)
        self.kind = kind
        self.message = message
        self.query = query

    def __str__(self) -> str:
        return f"[{self.kind}] {self.message}"


class ParseQueryError(QueryError, ParseError):
    """Parse-stage QueryError; also a sparql.parser.ParseError so callers
    catching ParseError keep working."""

    def __init__(self, message: str, query: str):
        QueryError.__init__(self, "parse", message, query)


class QueryTimeoutError(QueryError, TimeoutError):
    """The per-request wall-clock deadline expired before the result
    resolved (kind="timeout"); also a TimeoutError. The batch the request
    rode in keeps running and stays cached — only this caller gives up,
    and the decode stage skips the abandoned slot."""

    def __init__(self, message: str, query: str):
        QueryError.__init__(self, "timeout", message, query)


@dataclasses.dataclass
class SPARQLServer:
    engine: QueryEngine
    max_batch: int = 8
    max_wait_s: float = 0.002
    prepared_cache_entries: int = 256
    default_timeout_s: float = 30.0  # per-request deadline when none given

    def __post_init__(self):
        self._decode_pool = DecodePool(DECODE_WORKERS, DECODE_QUEUE)
        self._batcher = MicroBatcher(self._run_batch, self.max_batch,
                                     self._decode_pool, self.max_wait_s)
        self._prepared: OrderedDict[str, PreparedQuery] = OrderedDict()
        # request-path instruments live on the engine's registry so one
        # render_prometheus() scrape covers both layers; stats() reads the
        # instruments back (the registry is the source of truth)
        m = self.engine.metrics
        self._m_requests = m.counter(
            "mapsq_requests_total",
            "query requests by terminal outcome (counted exactly once, "
            "at the submitting call site)",
            labelnames=("outcome",),
        )
        for outcome in ("ok", "timeout", "error"):
            self._m_requests.labels(outcome=outcome)  # render zeros
        self._m_latency = m.histogram(
            "mapsq_request_latency_seconds",
            "end-to-end request latency: submit to resolve/timeout",
        )
        self._m_prepared_hits = m.counter(
            "mapsq_prepared_cache_hits_total",
            "server-side PreparedQuery handle cache hits",
        )
        self._m_prepared_misses = m.counter(
            "mapsq_prepared_cache_misses_total",
            "server-side PreparedQuery handle cache misses",
        )
        self._m_update_requests = m.counter(
            "mapsq_update_requests_total", "SPARQL UPDATE requests applied"
        )
        self._m_rows_inserted = m.counter(
            "mapsq_update_rows_inserted_total", "rows inserted via UPDATE"
        )
        self._m_rows_deleted = m.counter(
            "mapsq_update_rows_deleted_total", "rows deleted via UPDATE"
        )
        # pipeline-stage counters kept as plain attributes on the batcher/
        # decode-pool hot paths, mirrored into the registry at scrape time
        m_batches = m.counter(
            "mapsq_batches_total", "micro-batches dispatched"
        )
        m_deferred = m.counter(
            "mapsq_deferred_total",
            "result slots handed to the decode stage",
        )
        m_dispatch_s = m.counter(
            "mapsq_dispatch_seconds_total",
            "batcher-thread seconds inside batch_fn (group + dispatch)",
        )
        m_decoded = m.counter(
            "mapsq_decode_decoded_total", "decode-pool slots finalised"
        )
        m_dec_errors = m.counter(
            "mapsq_decode_errors_total",
            "decode-pool slots whose fn raised",
        )
        m_dec_skipped = m.counter(
            "mapsq_decode_skipped_total",
            "abandoned slots dropped undecoded",
        )
        m_depth = m.gauge(
            "mapsq_decode_queue_depth", "undecoded slots waiting"
        )

        def _collect() -> None:
            m_batches.set_total(self._batcher.n_batches)
            m_deferred.set_total(self._batcher.n_deferred)
            m_dispatch_s.set_total(self._batcher.dispatch_s)
            ds = self._decode_pool.stats()
            m_decoded.set_total(ds["decoded"])
            m_dec_errors.set_total(ds["errors"])
            m_dec_skipped.set_total(ds["skipped"])
            m_depth.set(ds["depth"])

        m.register_collector(_collect)

    def _prepared_handle(
        self, text: str, trace=None
    ) -> tuple[PreparedQuery, bool]:
        pq = self._prepared.get(text)
        if pq is not None:
            self._m_prepared_hits.inc()
            self._prepared.move_to_end(text)
            return pq, True
        self._m_prepared_misses.inc()
        pq = self.engine.prepare(text, trace=trace)
        self._prepared[text] = pq
        while len(self._prepared) > self.prepared_cache_entries:
            self._prepared.popitem(last=False)
        return pq, False

    def _deferred(self, pending: PendingDecode, text: str,
                  cached: bool) -> Deferred:
        """Wrap a dispatched-but-undecoded slot for the decode stage: the
        callable resolves the decode and types the envelope; any decode
        failure becomes a QueryError raised on the submitter's thread."""
        def fn() -> QueryResult:
            try:
                rs = pending.resolve()
            except Exception as e:
                raise QueryError("decode", str(e), query=text) from e
            return QueryResult(rows=rs.rows, vars=rs.vars, from_cache=cached)
        return Deferred(fn)

    def _run_batch(
        self, payloads: list
    ) -> "list[QueryResult | QueryError | Deferred]":
        """The pipeline's DISPATCH stage, on the batcher thread: same-shape
        (and padded near-miss-shape) queries coalesce into stacked device
        dispatches via engine.run_batch_pipelined, and each successfully
        dispatched slot returns as a Deferred whose decode runs on the
        decode pool. Every failure (parse, plan, execution) stays isolated
        to its own slot — one bad query never fails its batchmates or the
        worker thread.

        Payloads are query strings, or (text, trace) pairs when the
        request carries a per-query trace — the trace rides through
        prepare (parse/optimize spans), the stacked dispatch fan-out and
        the PendingDecode (transfer/decode spans)."""
        queries: list[str] = []
        traces: list = []
        for p in payloads:
            if isinstance(p, tuple):
                queries.append(p[0])
                traces.append(p[1])
            else:
                queries.append(p)
                traces.append(None)
        outs: list[QueryResult | QueryError | Deferred | None] = (
            [None] * len(queries)
        )
        pending: list[tuple[int, "PreparedQuery", bool]] = []
        for i, text in enumerate(queries):
            try:
                pq, cached = self._prepared_handle(text, trace=traces[i])
            except ParseError as e:
                outs[i] = ParseQueryError(str(e), query=text)
            except Exception as e:
                outs[i] = QueryError("plan", str(e), query=text)
            else:
                pending.append((i, pq, cached))
        if not pending:
            return outs
        outcomes = self.engine.run_batch_pipelined(
            [pq for _, pq, _ in pending],
            traces=[traces[i] for i, _, _ in pending],
        )
        for (i, pq, cached), oc in zip(pending, outcomes):
            if isinstance(oc, Exception):
                outs[i] = QueryError("execution", str(oc), query=queries[i])
            else:
                outs[i] = self._deferred(oc, queries[i], cached)
        return outs

    def query(self, text: str,
              timeout_ms: "float | None" = None) -> QueryResult:
        """Submit one query; raises QueryError (a ParseQueryError for parse
        failures) on this thread if the request failed. `timeout_ms` caps
        the request's wall-clock wait — dispatch queueing AND decode — and
        raises QueryTimeoutError on expiry (the server keeps running the
        batch; only this caller gives up).

        This is the request's ONE terminal-outcome accounting site: it
        resolves to exactly one of ok/timeout/error here, regardless of
        what the decode stage later does with an abandoned slot. The
        per-request trace (when the engine has a Tracer) is also finished
        here, in the finally — every span the pipeline recorded on it is
        born closed, so the finished trace has zero open spans even on
        the timeout and failure paths."""
        timeout = (
            timeout_ms / 1000.0 if timeout_ms is not None
            else self.default_timeout_s
        )
        tracer = self.engine.tracer
        trace = (
            tracer.new_trace("query", query=text[:120])
            if tracer is not None else None
        )
        payload = (text, trace) if trace is not None else text
        t0 = time.perf_counter()
        outcome = "error"
        try:
            res = self._batcher.submit(payload, timeout=timeout,
                                       trace=trace)
            outcome = "ok"
            return res
        except BatchTimeout as e:
            outcome = "timeout"
            raise QueryTimeoutError(
                f"query did not resolve within {timeout * 1000:.0f} ms",
                query=text,
            ) from e
        finally:
            self._m_requests.labels(outcome=outcome).inc()
            self._m_latency.observe(time.perf_counter() - t0)
            if trace is not None:
                tracer.finish(trace, outcome=outcome)

    def update(self, text: str) -> UpdateResult:
        """Apply a SPARQL UPDATE request (`INSERT DATA` / `DELETE DATA`,
        `;`-separated) against the live store.

        Updates run synchronously on the caller's thread under the store's
        snapshot lock — in-flight query batches that already staged their
        scans keep their pinned snapshot, later requests see the new store
        version. Prepared handles cached by the server stay valid: they
        re-stage scans at the current version on their next run (a query
        whose scan outgrows its capacity bucket simply compiles one new
        plan-cache entry). Parse failures raise ParseQueryError."""
        try:
            res = self.engine.update(text)
        except ParseQueryError:
            raise
        except ParseError as e:
            raise ParseQueryError(str(e), query=text) from e
        self._m_update_requests.inc()
        self._m_rows_inserted.inc(res.inserted)
        self._m_rows_deleted.inc(res.deleted)
        return res

    def explain(self, text: str, analyze: bool = False) -> str:
        """Host-side plan report (algebra, optimizer trace, physical plan,
        cache state) for a query, through the prepared-handle cache. With
        `analyze=True`, appends the EXPLAIN ANALYZE section — estimated vs
        actual rows per join node from the handle's last run (running the
        query once if it never ran)."""
        pq, _ = self._prepared_handle(text)
        return pq.explain(analyze=analyze)

    def save_cache(self, path: str) -> int:
        """Persist the engine's learned bucket signatures (see
        QueryEngine.save_cache); a restarted server constructed with
        QueryEngine(warmup_path=...) skips calibration for these shapes."""
        return self.engine.save_cache(path)

    def render_prometheus(self) -> str:
        """One text-exposition scrape of the shared registry: request
        outcomes/latency, prepared-cache and update counters (direct
        instruments) plus the engine's pipeline/padding/cache/store
        bridge collectors."""
        return self.engine.metrics.render_prometheus()

    def recent_traces(self) -> list:
        """The tracer's bounded ring of finished per-query traces
        (oldest first); empty when the engine has no Tracer."""
        t = self.engine.tracer
        return t.recent() if t is not None else []

    def slow_queries(self) -> list:
        """Finished traces that crossed the tracer's slow_ms threshold."""
        t = self.engine.tracer
        return t.slow_queries() if t is not None else []

    def stats(self) -> dict:
        hits = int(self._m_prepared_hits.value)
        misses = int(self._m_prepared_misses.value)
        total = hits + misses
        eng = self.engine
        sd, sq = eng.stacked_dispatches, eng.stacked_queries
        # snapshot before sorting: the worker thread inserts new histogram
        # keys concurrently with a client thread reading stats
        width_hist = dict(eng.batch_width_hist)
        arrival_hist = dict(self._batcher.batch_size_hist)
        pc, rc = eng.padded_cells, eng.real_cells
        return {
            "batches": self._batcher.n_batches,
            "requests": self._batcher.n_requests,
            "timeouts": int(
                self._m_requests.labels(outcome="timeout").value
            ),
            "plan_cache": self.engine.cache_stats(),
            "scan_cache": self.engine.store.scan_cache_stats(),
            "store": self.engine.store.write_stats(),
            "updates": {
                "requests": int(self._m_update_requests.value),
                "rows_inserted": int(self._m_rows_inserted.value),
                "rows_deleted": int(self._m_rows_deleted.value),
            },
            "prepared_cache": {
                "entries": len(self._prepared),
                "hits": hits,
                "misses": misses,
                "hit_rate": hits / total if total else 0.0,
            },
            # the coalescing win: how many device dispatches were stacked,
            # how many queries each one carried, at which lane widths, and
            # what cross-shape padding bought (merges taken/rejected and
            # the padded-vs-real scan-cell waste ratio)
            "batched": {
                "stacked_dispatches": sd,
                "stacked_queries": sq,
                "queries_per_dispatch": sq / sd if sd else 0.0,
                "batch_width_hist": dict(sorted(width_hist.items())),
                "arrival_batch_hist": dict(sorted(arrival_hist.items())),
                "padding": {
                    "padded_groups": eng.padded_groups,
                    "pad_rejects": eng.pad_rejects,
                    "padded_cells": pc,
                    "real_cells": rc,
                    "waste_ratio": (pc - rc) / rc if rc else 0.0,
                },
            },
            # the two pipeline stages' health: slots handed to the decode
            # side, batcher time spent in dispatch, device busy seconds
            # (1 - Δdevice_time_s / wall is the bench's idle fraction)
            "pipeline": {
                "deferred": self._batcher.n_deferred,
                "dispatch_s": self._batcher.dispatch_s,
                "device_time_s": eng.device_time_s,
                "decode": self._decode_pool.stats(),
            },
        }

    def close(self) -> None:
        self._batcher.close()
        self._decode_pool.close()
