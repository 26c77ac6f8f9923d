"""Lightweight span tracing for the query path.

One `Trace` per request, a tree of `Span`s under its root covering
parse -> optimize -> compile -> dispatch -> transfer -> decode. Clocks
are monotonic (`time.perf_counter`); a wall-clock epoch captured at
trace creation anchors the Chrome trace-event export. Everything is
thread-safe: spans are appended under the trace's lock, because a
request's spans are produced on three different threads (submitter,
batcher, decode worker).

Two span styles, chosen for leak-freedom:

  * context-managed (`trace.span("parse")`) — closes on the `with`
    exit, exceptions included;
  * retroactive (`trace.add_span(name, t0, t1)`) — created already
    closed from measured timestamps. The engine uses these for
    dispatch/compile/transfer/decode, so a span recorded from a worker
    thread can never be left open by a crash: either the interval
    completed and is recorded closed, or nothing is recorded.

Only the root span (closed by `Tracer.finish`, which callers invoke in
a `finally`) and context-managed spans can be open at all; the
leaked-span tests assert `open_spans()` is empty over the whole ring.

A stacked dispatch fans ONE device launch out to N lane traces: each
lane records its own "dispatch" span over the same interval, correlated
by a shared `dispatch_id` attribute.

`Tracer` owns the bounded ring of finished traces (the server's
`recent_traces()`) and the slow-query log: traces whose total duration
crosses `slow_ms` are kept separately with their full span tree and the
plan signature the engine attached.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Iterable

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
        # perf_counter origin + wall epoch: exports need absolute time
        self.origin = time.perf_counter()
        self.epoch_s = time.time()
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

    # -- queries -----------------------------------------------------------
    @property
    def duration_s(self) -> float:
        return self.root.duration_s

    def open_spans(self) -> list[Span]:
        with self._lock:
            return [s for s in self.spans if s.open]

    def find(self, name: str) -> list[Span]:
        with self._lock:
            return [s for s in self.spans if s.name == name]

    # -- exports -----------------------------------------------------------
    def to_chrome_events(self, pid: int = 1) -> list[dict]:
        """Chrome trace-event JSON (the `chrome://tracing` / Perfetto
        format): complete ("X") events, microsecond timestamps anchored
        to the trace's wall epoch."""
        base_us = self.epoch_s * 1e6
        out = []
        with self._lock:
            spans = list(self.spans)
        for s in spans:
            t1 = s.t1 if not s.open else self._now()
            out.append({
                "name": s.name,
                "cat": "query",
                "ph": "X",
                "ts": base_us + s.t0 * 1e6,
                "dur": max(0.0, t1 - s.t0) * 1e6,
                "pid": pid,
                "tid": s.thread,
                "args": dict(
                    s.attrs,
                    trace_id=self.trace_id,
                    span_id=s.span_id,
                    parent_id=s.parent_id,
                ),
            })
        return out

    def tree_str(self) -> str:
        """Indented span tree with durations — the slow-query log line."""
        with self._lock:
            spans = list(self.spans)
        kids: dict[int | None, list[Span]] = {}
        for s in spans:
            kids.setdefault(s.parent_id, []).append(s)
        lines: list[str] = []

        def walk(s: Span, depth: int) -> None:
            dur = "open" if s.open else f"{s.duration_s * 1e3:.2f}ms"
            extra = "".join(
                f" {k}={v}" for k, v in sorted(s.attrs.items())
            )
            lines.append(f"{'  ' * depth}{s.name} {dur}{extra}")
            for c in sorted(kids.get(s.span_id, ()), key=lambda x: x.t0):
                walk(c, depth + 1)

        walk(self.root, 0)
        return "\n".join(lines)


class Tracer:
    """Trace factory + bounded ring of finished traces + slow-query log.

    `slow_ms=None` disables the slow log; otherwise any finished trace
    whose duration crosses the threshold is kept (ring-bounded) with its
    full span tree and whatever `plan_sig` attribute the engine set."""

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

    def open_span_count(self) -> int:
        """Leaked (still-open) spans across every retired trace — the
        zero-leak acceptance check."""
        return sum(len(t.open_spans()) for t in self.recent())

    def export_chrome(self) -> list[dict]:
        events: list[dict] = []
        for t in self.recent():
            events.extend(t.to_chrome_events())
        return events


def phase_totals(traces: Iterable[Trace]) -> dict[str, float]:
    """Total seconds spent per span name across traces — the per-phase
    latency breakdown (dispatch vs transfer vs decode) the serving bench
    reports at the saturating burst. Open spans contribute nothing."""
    out: dict[str, float] = {}
    for t in traces:
        with t._lock:
            spans = list(t.spans)
        for s in spans:
            if not s.open:
                out[s.name] = out.get(s.name, 0.0) + s.duration_s
    return out


# -- trace JSON schema validation ---------------------------------------------
# A deliberately small JSON-Schema subset (type / required / properties /
# items / enum / minimum), enough to validate the Chrome trace-event export
# against the checked-in docs/trace_schema.json without external deps.

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "number": (int, float),
    "integer": int,
    "boolean": bool,
}


def validate_chrome_events(value: Any, schema: dict,
                           path: str = "$") -> list[str]:
    """Validate `value` against the schema subset; returns a list of
    error strings (empty = valid)."""
    errs: list[str] = []
    typ = schema.get("type")
    if typ is not None:
        expected = _TYPES[typ]
        if typ == "number" and isinstance(value, bool):
            errs.append(f"{path}: expected number, got bool")
        elif not isinstance(value, expected) or (
            typ == "integer" and isinstance(value, bool)
        ):
            errs.append(f"{path}: expected {typ}, "
                        f"got {type(value).__name__}")
            return errs
    if "enum" in schema and value not in schema["enum"]:
        errs.append(f"{path}: {value!r} not in {schema['enum']}")
    if "minimum" in schema and isinstance(value, (int, float)):
        if value < schema["minimum"]:
            errs.append(f"{path}: {value} < minimum {schema['minimum']}")
    if isinstance(value, dict):
        for req in schema.get("required", ()):
            if req not in value:
                errs.append(f"{path}: missing required key {req!r}")
        for k, sub in schema.get("properties", {}).items():
            if k in value:
                errs.extend(
                    validate_chrome_events(value[k], sub, f"{path}.{k}")
                )
    if isinstance(value, list) and "items" in schema:
        for i, item in enumerate(value):
            errs.extend(
                validate_chrome_events(item, schema["items"], f"{path}[{i}]")
            )
    return errs
