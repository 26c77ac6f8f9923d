"""Metrics registry: counters and gauges with a Prometheus text exposition.

One `MetricsRegistry` per engine (`engine.metrics`). The engine keeps its
hot-path counters as plain attributes (device_time_s, the plan/scan cache
dicts); a callback registered with `register_collector` mirrors them into
instruments at scrape time, so the dispatch path pays nothing for
exposition.
"""
from __future__ import annotations

import re
import threading
from typing import Callable

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    @property
    def value(self) -> float:
        return self._value

    def render(self) -> list[str]:
        return [f"{self.name} {_fmt(self._value)}"]


class Counter(_Metric):
    kind = "counter"

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += v

    def set_total(self, v: float) -> None:
        """Bridge entry point for collector callbacks mirroring an
        external cumulative value; monotone (never moves backwards)."""
        with self._lock:
            self._value = max(self._value, float(v))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)


class MetricsRegistry:
    """Name -> instrument, plus scrape-time collector callbacks."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list[Callable[[], None]] = []

    def _get_or_create(self, cls, name: str, help: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"{name} already registered as {m.kind}"
                    )
                return m
            m = cls(name, help)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def register_collector(self, fn: Callable[[], None]) -> None:
        """`fn` runs at every scrape, before rendering — the bridge for
        counters kept as plain attributes on hot paths."""
        with self._lock:
            self._collectors.append(fn)

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            fn()

    def render_prometheus(self) -> str:
        """The text exposition format, one scrape: runs collectors, then
        renders every instrument with HELP/TYPE headers."""
        self.collect()
        with self._lock:
            metrics = sorted(self._metrics.items())
        lines: list[str] = []
        for name, m in metrics:
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(m.render())
        return "\n".join(lines) + "\n"
