"""Lightweight span tracing for the query path.

One `Trace` per request, a tree of `Span`s under its root covering
parse -> optimize -> compile -> dispatch -> transfer -> decode. Clocks
are monotonic (`time.perf_counter`). Spans are appended under the
trace's lock, so one trace may be shared across threads.

Two span styles, chosen for leak-freedom:

  * context-managed (`trace.span("parse")`) — closes on the `with`
    exit, exceptions included;
  * retroactive (`trace.add_span(name, t0, t1)`) — created already
    closed from measured timestamps. The engine uses these for
    dispatch/compile/transfer/decode, so a span recorded from a worker
    thread can never be left open by a crash: either the interval
    completed and is recorded closed, or nothing is recorded.

Only the root span (closed by `Tracer.finish`, which callers invoke in
a `finally`) and context-managed spans can be open at all.

`Tracer` owns the bounded ring of finished traces and the slow-query
log: traces whose total duration crosses `slow_ms` are kept separately.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any

_ids = itertools.count(1)


class Span:
    """One timed interval inside a trace. `t0`/`t1` are perf_counter
    seconds relative to the trace's origin; `t1 < 0` means still open."""

    __slots__ = ("span_id", "parent_id", "name", "t0", "t1", "attrs",
                 "thread")

    def __init__(self, span_id: int, parent_id: int | None, name: str,
                 t0: float, attrs: dict[str, Any]):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t0 = t0
        self.t1 = -1.0
        self.attrs = attrs
        self.thread = threading.get_ident()

    @property
    def open(self) -> bool:
        return self.t1 < 0.0

    @property
    def duration_s(self) -> float:
        return max(0.0, self.t1 - self.t0) if not self.open else 0.0

    def __repr__(self) -> str:
        state = "open" if self.open else f"{self.duration_s * 1e3:.2f}ms"
        return f"Span({self.name}, {state})"


class _SpanCtx:
    """Context manager that closes its span on exit, exceptions included
    (the error type is recorded as an attribute, not swallowed)."""

    __slots__ = ("trace", "span")

    def __init__(self, trace: "Trace", span: Span):
        self.trace = trace
        self.span = span

    def __enter__(self) -> Span:
        return self.span

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.span.attrs["error"] = exc_type.__name__
        self.trace.end(self.span)


class Trace:
    """One request's span tree. Append-only and thread-safe; spans keep
    arriving (from racing decode workers) even after `finish()` — they
    are recorded closed, so the leak invariant is unaffected."""

    def __init__(self, name: str, attrs: dict[str, Any] | None = None):
        self.trace_id = next(_ids)
        self._lock = threading.Lock()
        self.origin = time.perf_counter()
        self.spans: list[Span] = []
        self.root = Span(next(_ids), None, name, 0.0, dict(attrs or {}))
        self.spans.append(self.root)

    def _now(self) -> float:
        return time.perf_counter() - self.origin

    def start(self, name: str, parent: Span | None = None,
              **attrs: Any) -> Span:
        s = Span(
            next(_ids),
            (parent or self.root).span_id,
            name,
            self._now(),
            attrs,
        )
        with self._lock:
            self.spans.append(s)
        return s

    def end(self, span: Span, **attrs: Any) -> None:
        if attrs:
            span.attrs.update(attrs)
        span.t1 = self._now()

    def span(self, name: str, parent: Span | None = None,
             **attrs: Any) -> _SpanCtx:
        return _SpanCtx(self, self.start(name, parent, **attrs))

    def add_span(self, name: str, t0: float, t1: float,
                 parent: Span | None = None, **attrs: Any) -> Span:
        """Record an already-measured interval (perf_counter absolute
        seconds, as returned by time.perf_counter()). Born closed."""
        s = Span(
            next(_ids),
            (parent or self.root).span_id,
            name,
            t0 - self.origin,
            attrs,
        )
        s.t1 = t1 - self.origin
        with self._lock:
            self.spans.append(s)
        return s

    def finish(self, **attrs: Any) -> None:
        if self.root.open:
            self.end(self.root, **attrs)
        elif attrs:
            self.root.attrs.update(attrs)

    @property
    def duration_s(self) -> float:
        return self.root.duration_s


class Tracer:
    """Trace factory + bounded ring of finished traces + slow-query log.

    `slow_ms=None` disables the slow log; otherwise any finished trace
    whose duration crosses the threshold is kept (ring-bounded)."""

    def __init__(self, ring_size: int = 256, slow_ms: float | None = None,
                 slow_log_size: int = 64):
        self.ring_size = max(1, ring_size)
        self.slow_ms = slow_ms
        self.slow_log_size = max(1, slow_log_size)
        self._lock = threading.Lock()
        self._ring: list[Trace] = []
        self._slow: list[Trace] = []
        self.n_traces = 0
        self.n_slow = 0

    def new_trace(self, name: str = "query",
                  **attrs: Any) -> Trace:
        return Trace(name, attrs)

    def finish(self, trace: Trace, **attrs: Any) -> None:
        """Close the trace's root and retire it into the ring (and the
        slow log when it crossed the threshold). Must be called exactly
        once per trace, in the request path's `finally`."""
        trace.finish(**attrs)
        with self._lock:
            self.n_traces += 1
            self._ring.append(trace)
            if len(self._ring) > self.ring_size:
                del self._ring[: len(self._ring) - self.ring_size]
            if (
                self.slow_ms is not None
                and trace.duration_s * 1e3 >= self.slow_ms
            ):
                self.n_slow += 1
                self._slow.append(trace)
                if len(self._slow) > self.slow_log_size:
                    del self._slow[: len(self._slow) - self.slow_log_size]

    def recent(self) -> list[Trace]:
        with self._lock:
            return list(self._ring)

    def slow_queries(self) -> list[Trace]:
        with self._lock:
            return list(self._slow)
