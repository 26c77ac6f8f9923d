"""Observability: span tracing, the unified metrics registry, and the
helpers behind EXPLAIN ANALYZE.

Zero dependencies beyond the standard library — the engine and the
serving tier import this unconditionally, so it must cost nothing when
tracing is off.
"""
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    log_buckets,
    parse_prometheus,
    quantile_from_samples,
)
from repro_torch.obs.trace import (  # noqa: F401
    Span,
    Trace,
    Tracer,
    phase_totals,
    validate_chrome_events,
)
