"""Unified metrics registry: counters, gauges, log-bucketed histograms,
and a Prometheus text exposition.

One `MetricsRegistry` per engine (`engine.metrics`); the server registers
its request-path metrics on the same instance so `render_prometheus()`
is a single scrape covering every layer. Two integration styles:

  * direct instruments — request outcomes, latencies, timeouts, update
    counters: incremented/observed at the event site (the registry is
    the source of truth; `stats()` reads the instrument back);
  * collector callbacks — hot-path counters the engine keeps as plain
    attributes (padded_cells, stacked_dispatches, device_time_s, the
    plan/scan cache dicts): a callback registered with
    `register_collector` mirrors them into instruments at scrape time,
    so the dispatch path pays nothing for exposition.

Histograms are log-bucketed: boundaries grow geometrically (factor 2 by
default) from `start`, which matches latency's dynamic range with a
handful of buckets and renders as a valid cumulative Prometheus
histogram (`_bucket{le=...}` non-decreasing, `+Inf` == `_count`).

`parse_prometheus` is the exposition's own validator (used by tests and
the obs-smoke CI gate): it checks line grammar, label syntax, histogram
bucket monotonicity and the `+Inf`/_count agreement.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Any, Callable, Iterable

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _label_str(labelnames: tuple[str, ...], labelvalues: tuple) -> str:
    if not labelnames:
        return ""
    pairs = ",".join(
        f'{k}="{str(v)}"' for k, v in zip(labelnames, labelvalues)
    )
    return "{" + pairs + "}"


class _Metric:
    """Common child-per-labelset machinery."""

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: tuple[str, ...] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"bad label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple, Any] = {}
        if not self.labelnames:
            # a label-free instrument exposes its zero from birth (labelled
            # children appear on first labels() touch, as in prometheus)
            self._children[()] = self._make_child()

    def labels(self, **kv: Any):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(kv)}"
            )
        key = tuple(str(kv[ln]) for ln in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
            return child

    def _default_child(self):
        """The label-free instrument (lazily created)."""
        if self.labelnames:
            raise ValueError(f"{self.name} requires labels()")
        with self._lock:
            child = self._children.get(())
            if child is None:
                child = self._make_child()
                self._children[()] = child
            return child

    def _items(self) -> list[tuple[tuple, Any]]:
        with self._lock:
            return sorted(self._children.items())


class _CounterChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

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

    @property
    def value(self) -> float:
        return self._value


class Counter(_Metric):
    kind = "counter"

    def _make_child(self) -> _CounterChild:
        return _CounterChild()

    def inc(self, v: float = 1.0) -> None:
        self._default_child().inc(v)

    def set_total(self, v: float) -> None:
        self._default_child().set_total(v)

    @property
    def value(self) -> float:
        return self._default_child().value

    def render(self) -> list[str]:
        return [
            f"{self.name}{_label_str(self.labelnames, k)} {_fmt(c.value)}"
            for k, c in self._items()
        ]


class _GaugeChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._value += v

    def dec(self, v: float = 1.0) -> None:
        self.inc(-v)

    @property
    def value(self) -> float:
        return self._value


class Gauge(_Metric):
    kind = "gauge"

    def _make_child(self) -> _GaugeChild:
        return _GaugeChild()

    def set(self, v: float) -> None:
        self._default_child().set(v)

    def inc(self, v: float = 1.0) -> None:
        self._default_child().inc(v)

    def dec(self, v: float = 1.0) -> None:
        self._default_child().dec(v)

    @property
    def value(self) -> float:
        return self._default_child().value

    def render(self) -> list[str]:
        return [
            f"{self.name}{_label_str(self.labelnames, k)} {_fmt(c.value)}"
            for k, c in self._items()
        ]


def log_buckets(start: float = 0.0005, factor: float = 2.0,
                count: int = 16) -> tuple[float, ...]:
    """Geometric bucket boundaries: start, start*factor, ... — latency's
    dynamic range in `count` buckets (default 0.5ms .. ~16s)."""
    return tuple(start * factor ** i for i in range(count))


class _HistogramChild:
    __slots__ = ("_lock", "buckets", "counts", "sum", "count")

    def __init__(self, buckets: tuple[float, ...]):
        self._lock = threading.Lock()
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        # first bucket whose upper bound contains v (binary search is
        # overkill at <=16 buckets)
        i = 0
        for i, b in enumerate(self.buckets):
            if v <= b:
                break
        else:
            i = len(self.buckets)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper bound of the bucket the
        q-quantile observation landed in)."""
        with self._lock:
            total = self.count
            counts = list(self.counts)
        if total == 0:
            return 0.0
        target = math.ceil(q * total)
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= target:
                return (
                    self.buckets[i] if i < len(self.buckets)
                    else float("inf")
                )
        return float("inf")


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str,
                 labelnames: tuple[str, ...] = (),
                 buckets: tuple[float, ...] | None = None):
        b = tuple(sorted(buckets)) if buckets else log_buckets()
        if not b or any(
            b[i] >= b[i + 1] for i in range(len(b) - 1)
        ):
            raise ValueError("buckets must be strictly increasing")
        self.buckets = b  # before super(): _make_child reads it
        super().__init__(name, help, labelnames)

    def _make_child(self) -> _HistogramChild:
        return _HistogramChild(self.buckets)

    def observe(self, v: float) -> None:
        self._default_child().observe(v)

    def quantile(self, q: float) -> float:
        return self._default_child().quantile(q)

    def render(self) -> list[str]:
        lines = []
        for key, c in self._items():
            cum = 0
            with c._lock:
                counts = list(c.counts)
                total = c.count
                s = c.sum
            for b, n in zip(self.buckets, counts):
                cum += n
                le = _label_str(
                    self.labelnames + ("le",), key + (_fmt(b),)
                )
                lines.append(f"{self.name}_bucket{le} {cum}")
            le = _label_str(self.labelnames + ("le",), key + ("+Inf",))
            lines.append(f"{self.name}_bucket{le} {total}")
            base = _label_str(self.labelnames, key)
            lines.append(f"{self.name}_sum{base} {repr(float(s))}")
            lines.append(f"{self.name}_count{base} {total}")
        return lines


class MetricsRegistry:
    """Name -> instrument, plus scrape-time collector callbacks."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list[Callable[[], None]] = []

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: tuple[str, ...], **kw) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"{name} already registered as {m.kind}"
                    )
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: tuple[str, ...] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple[str, ...] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: tuple[str, ...] = (),
                  buckets: tuple[float, ...] | None = None) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

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


# -- exposition validation ----------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+"
    r"(?P<value>[-+]?(?:\d+\.?\d*(?:[eE][-+]?\d+)?|Inf|NaN))$"
)
_LABEL_PAIR_RE = re.compile(
    r'^[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"$'
)


def parse_prometheus(text: str) -> dict[str, list[tuple[dict, float]]]:
    """Parse (and validate) a text exposition; raises ValueError on any
    grammar violation, histogram bucket non-monotonicity, or +Inf/_count
    disagreement. Returns {metric_name: [(labels, value), ...]}."""
    out: dict[str, list[tuple[dict, float]]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: unparseable sample {line!r}")
        labels: dict[str, str] = {}
        if m.group("labels"):
            for pair in m.group("labels").split(","):
                if not _LABEL_PAIR_RE.match(pair):
                    raise ValueError(
                        f"line {lineno}: bad label pair {pair!r}"
                    )
                k, v = pair.split("=", 1)
                labels[k] = v[1:-1]
        raw = m.group("value")
        value = float(raw.replace("Inf", "inf"))
        out.setdefault(m.group("name"), []).append((labels, value))
    _check_histograms(out)
    return out


def _check_histograms(
    samples: dict[str, list[tuple[dict, float]]]
) -> None:
    for name in [n for n in samples if n.endswith("_bucket")]:
        base = name[: -len("_bucket")]
        series: dict[tuple, list[tuple[float, float]]] = {}
        for labels, value in samples[name]:
            le = labels.get("le")
            if le is None:
                raise ValueError(f"{name}: bucket sample without le")
            key = tuple(sorted(
                (k, v) for k, v in labels.items() if k != "le"
            ))
            series.setdefault(key, []).append(
                (float(le.replace("+Inf", "inf")), value)
            )
        for key, buckets in series.items():
            buckets.sort()
            counts = [c for _, c in buckets]
            if any(
                a > b for a, b in zip(counts, counts[1:])
            ):
                raise ValueError(
                    f"{base}: bucket counts not monotone at {dict(key)}"
                )
            if buckets[-1][0] != float("inf"):
                raise ValueError(f"{base}: missing +Inf bucket")
            for labels, value in samples.get(f"{base}_count", ()):
                if tuple(sorted(labels.items())) == key and (
                    value != buckets[-1][1]
                ):
                    raise ValueError(
                        f"{base}: +Inf bucket != _count at {dict(key)}"
                    )


def quantile_from_samples(values: Iterable[float], q: float) -> float:
    """Plain percentile helper (numpy-free) for the bench's overhead
    guard."""
    vs = sorted(values)
    if not vs:
        return 0.0
    idx = min(len(vs) - 1, max(0, int(round(q * (len(vs) - 1)))))
    return vs[idx]
