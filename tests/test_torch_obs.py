"""The port's observability (`repro_torch.obs`) against the reference's
(`repro.obs`): the same operations give the same Prometheus text, the same
parse, the same Chrome trace-event export (under one fixed clock), which
validates against docs/trace_schema.json — and the engine and server
expose the same metric families with the same deterministic values."""
import itertools
import json
import pathlib

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import pytest
import torch  # noqa: F401

import repro.obs.trace as j_trace_mod
import repro_torch.obs.trace as t_trace_mod
from repro import obs as j_obs
from repro.serve.sparql_server import SPARQLServer as JServer
from repro.sparql.engine import QueryEngine as JEngine
from repro.sparql.store import store_from_string_triples as j_store
from repro_torch import obs as t_obs
from repro_torch.serve.sparql_server import SPARQLServer as TServer
from repro_torch.sparql.engine import QueryEngine as TEngine
from repro_torch.sparql.store import store_from_string_triples as t_store

SCHEMA = json.loads(
    (pathlib.Path(__file__).resolve().parents[1] / "docs" / "trace_schema.json")
    .read_text()
)


def drive_metrics(obs):
    """One fixed sequence of instrument operations on a fresh registry."""
    m = obs.MetricsRegistry()
    c = m.counter("mapsq_requests_total", "requests", labelnames=("outcome",))
    for outcome, n in (("ok", 5), ("error", 2), ("timeout", 0)):
        c.labels(outcome=outcome).inc(n)
    m.counter("mapsq_plain_total", "a plain counter").inc(3)
    g = m.gauge("mapsq_depth", "a gauge")
    g.set(7)
    g.dec(2)
    h = m.histogram("mapsq_latency_seconds", "latency")
    for v in (0.0001, 0.0004, 0.003, 0.02, 0.5, 9.0, 100.0):
        h.observe(v)
    hl = m.histogram("mapsq_sizes", "sizes", labelnames=("kind",),
                     buckets=obs.log_buckets(1.0, 4.0, 5))
    for v in (1, 3, 17, 300):
        hl.labels(kind="a").observe(v)
    hl.labels(kind="b").observe(2)
    m.register_collector(lambda: m.gauge("mapsq_collected", "c").set(11))
    return m, h


def test_prometheus_text_and_parse_match_reference():
    (jm, jh), (tm, th) = drive_metrics(j_obs), drive_metrics(t_obs)
    text = tm.render_prometheus()
    assert text == jm.render_prometheus()
    assert t_obs.parse_prometheus(text) == j_obs.parse_prometheus(text)
    for q in (0.5, 0.9, 0.99):
        assert th.quantile(q) == jh.quantile(q)


@pytest.mark.parametrize("bad", [
    "mapsq_x{le=\"1\" 3",  # unterminated labels
    "mapsq_h_bucket{le=\"1\"} 5\nmapsq_h_bucket{le=\"+Inf\"} 3\n"
    "mapsq_h_count 3",  # non-monotone buckets
    "mapsq_h_bucket{le=\"1\"} 1\nmapsq_h_bucket{le=\"+Inf\"} 3\n"
    "mapsq_h_count 4",  # +Inf != _count
])
def test_prometheus_validator_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        j_obs.parse_prometheus(bad)
    with pytest.raises(ValueError):
        t_obs.parse_prometheus(bad)


def test_quantile_from_samples_matches_reference():
    xs = [0.5, 3.0, 1.0, 9.0, 2.0, 7.5]
    for q in (0.0, 0.5, 0.9, 1.0):
        assert t_obs.quantile_from_samples(xs, q) == \
            j_obs.quantile_from_samples(xs, q)


def drive_traces(obs, mod, monkeypatch):
    """One fixed sequence of spans on a Tracer, under a fixed clock."""
    ticks = itertools.count()
    monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks) * 0.001)
    monkeypatch.setattr(mod.time, "time", lambda: 1_700_000_000.0)
    monkeypatch.setattr(mod, "_ids", itertools.count(1))
    tracer = obs.Tracer(ring_size=8, slow_ms=2.5)
    for i in range(3):
        tr = tracer.new_trace("query", query=f"q{i}")
        with tr.span("parse"):
            pass
        sp = tr.start("dispatch", width=4)
        tr.end(sp, stacked=True)
        tr.add_span("decode", 0.002, 0.004 + i, rows=i)
        tracer.finish(tr, outcome="ok")
    return tracer


def test_chrome_export_matches_reference_and_schema(monkeypatch):
    jt = drive_traces(j_obs, j_trace_mod, monkeypatch)
    tt = drive_traces(t_obs, t_trace_mod, monkeypatch)
    events = tt.export_chrome()
    assert events == jt.export_chrome()
    assert t_obs.validate_chrome_events(events, SCHEMA) == []
    assert t_obs.validate_chrome_events(events, SCHEMA) == \
        j_obs.validate_chrome_events(events, SCHEMA)
    assert [t.tree_str() for t in tt.slow_queries()] == [
        t.tree_str() for t in jt.slow_queries()
    ]
    assert t_obs.phase_totals(tt.recent()) == j_obs.phase_totals(jt.recent())
    assert tt.open_span_count() == jt.open_span_count() == 0


def test_schema_validator_flags_what_the_reference_flags():
    bad = [{"name": "x", "ph": "Q", "ts": "late", "dur": -1}]
    assert t_obs.validate_chrome_events(bad, SCHEMA) == \
        j_obs.validate_chrome_events(bad, SCHEMA)
    assert t_obs.validate_chrome_events(bad, SCHEMA)


def _families(text: str) -> dict[str, list]:
    return {
        name: samples for name, samples in t_obs.parse_prometheus(text).items()
    }


def test_server_metric_families_and_counts_match_reference():
    """The same requests through the JAX server and the port's: the same
    metric families; request, cache, stacking and padding counts equal
    (times differ by machine and are not compared)."""
    triples = [(f"<s{i}>", "<p>", f"<m{i % 3}>") for i in range(12)]
    triples += [(f"<m{j}>", "<q>", f"<z{j}>") for j in range(3)]
    texts = [f"SELECT ?x ?z WHERE {{ ?x <p> ?y . ?y <q> ?z . "
             f"FILTER (?x != <s{k}>) }}" for k in range(4)]
    scrapes = []
    for srv in (JServer(JEngine(j_store(triples)), max_batch=8),
                TServer(TEngine(t_store(triples), device="cpu"), max_batch=8)):
        try:
            for _ in range(2):
                for o in srv._run_batch(texts):
                    o.fn()
            srv.query(texts[0])
            scrapes.append(_families(srv.render_prometheus()))
        finally:
            srv.close()
    want, got = scrapes
    assert set(got) == set(want)
    timed = ("seconds", "latency")
    for name in want:
        if not any(t in name for t in timed):
            assert got[name] == want[name], name
