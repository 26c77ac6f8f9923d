"""Observability: span tracing and the metrics registry behind the
engine's EXPLAIN ANALYZE and Prometheus exposition.

Zero dependencies beyond the standard library; it costs nothing when
tracing is off (every hook is guarded by `trace is not None`).
"""
from repro_torch.obs.metrics import Counter, Gauge, MetricsRegistry  # noqa: F401
from repro_torch.obs.trace import Span, Trace, Tracer  # noqa: F401
