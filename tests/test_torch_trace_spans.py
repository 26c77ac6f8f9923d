"""The spans that split a served request's wait, through a traced
SPARQLServer on the CPU: `queue` (the micro-batcher's), `enqueue` under
each warm `dispatch` (with its on-CPU seconds `cpu_s`), `decode_queue`
(the decode pool's) and `cpu_s` on `transfer` and `decode`, on the
stacked and the solo path of QueryEngine and ShardedQueryEngine; and no
extra clock read when nothing is traced."""
import threading
import time

import pytest

from repro_torch.obs import Tracer
from repro_torch.serve.sparql_server import SPARQLServer
from repro_torch.sparql.engine import QueryEngine, ShardedQueryEngine
from repro_torch.sparql.sharded_store import shard_store
from repro_torch.sparql.store import store_from_string_triples

TEXT = "SELECT ?x ?z WHERE { ?x <p0> ?y . ?y <q> ?z . }"
N_ROWS = 20  # ten subjects, two objects of q through each of three m's
SLACK_S = 1e-3  # cpu_s may pass the wall by no more than this
EPS = 1e-9  # float slack of spans stored relative to their trace's origin


def _triples():
    triples = [(f"<s{i}>", "<p0>", f"<m{i % 3}>") for i in range(10)]
    for j in range(3):
        triples.append((f"<m{j}>", "<q>", f"<z{j}>"))
        triples.append((f"<m{j}>", "<q>", f"<z{j + 3}>"))
    return triples


def _engine(kind: str, tracer):
    store = store_from_string_triples(_triples())
    if kind == "sharded":
        return ShardedQueryEngine(shard_store(store, 2), device="cpu",
                                  tracer=tracer)
    return QueryEngine(store, device="cpu", tracer=tracer)


def _concurrently(fn, n: int) -> list:
    """`fn()` on `n` threads at once; their results."""
    out = [None] * n
    errors = []

    def one(k):
        try:
            out[k] = fn()
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(k,)) for k in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    assert not errors, errors[0]
    return out


def _serve(kind: str, stacked: bool, tracer, n: int = 6):
    """Warm `TEXT` with one request, then serve `n` more: all at once in
    one micro-batch (one stacked dispatch), or one at a time (solo
    dispatches). Returns (the server's stats, the warm requests' traces,
    their results)."""
    srv = SPARQLServer(_engine(kind, tracer),
                       max_batch=n if stacked else 1, max_wait_s=5.0)
    try:
        srv.query(TEXT)  # cold: calibrates and compiles
        if stacked:
            results = _concurrently(lambda: srv.query(TEXT), n)
        else:
            results = [srv.query(TEXT) for _ in range(n)]
        traces = srv.recent_traces()[1:] if tracer is not None else []
        return srv.stats(), traces, results
    finally:
        srv.close()


def _abs(trace, span) -> tuple[float, float]:
    return trace.origin + span.t0, trace.origin + span.t1


def _inside(inner, outer) -> bool:
    return outer[0] - EPS <= inner[0] <= inner[1] <= outer[1] + EPS


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "solo"])
@pytest.mark.parametrize("kind", ["single", "sharded"])
def test_every_warm_dispatch_has_one_enqueue_child(kind, stacked):
    tracer = Tracer(ring_size=64)
    stats, traces, results = _serve(kind, stacked, tracer)
    assert [len(r) for r in results] == [N_ROWS] * len(results)
    assert len(traces) == len(results)
    if stacked:
        assert stats["batched"]["stacked_dispatches"] == 1
    ids = set()
    for t in traces:
        (dispatch,) = t.find("dispatch")
        (enqueue,) = t.find("enqueue")
        assert enqueue.parent_id == dispatch.span_id
        for key in ("dispatch_id", "lane", "width", "n_shards"):
            assert enqueue.attrs.get(key) == dispatch.attrs.get(key), key
        assert ("dispatch_id" in dispatch.attrs) == stacked
        ids.add(dispatch.attrs.get("dispatch_id", dispatch.span_id))
        assert _inside(_abs(t, enqueue), _abs(t, dispatch))
        assert enqueue.t0 == pytest.approx(dispatch.t0, abs=EPS)
        assert 0.0 <= enqueue.attrs["cpu_s"] <= enqueue.duration_s + SLACK_S
    # one stacked dispatch fans out to every lane; solo ones are their own
    assert len(ids) == (1 if stacked else len(traces))
    if stacked:
        lanes = sorted(t.find("enqueue")[0].attrs["lane"] for t in traces)
        assert lanes == list(range(len(traces)))
    assert tracer.open_span_count() == 0


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "solo"])
@pytest.mark.parametrize("kind", ["single", "sharded"])
def test_queue_and_decode_queue_bound_the_request(kind, stacked):
    tracer = Tracer(ring_size=64)
    _, traces, results = _serve(kind, stacked, tracer)
    for t in traces:
        (queue,) = t.find("queue")
        (dispatch,) = t.find("dispatch")
        (decode_queue,) = t.find("decode_queue")
        (transfer,) = t.find("transfer")
        (decode,) = t.find("decode")
        assert queue.parent_id == t.root.span_id
        assert queue.attrs["batch"] == (len(results) if stacked else 1)
        assert 0.0 <= queue.t0 and queue.t1 <= dispatch.t0 + EPS
        assert dispatch.t1 <= decode_queue.t0 + EPS
        assert decode_queue.t1 <= transfer.t0 + EPS
        assert decode.attrs["rows"] == N_ROWS
        for span in (transfer, decode):
            assert 0.0 <= span.attrs["cpu_s"] <= span.duration_s + SLACK_S
    assert tracer.open_span_count() == 0


def _raise(*_):
    raise AssertionError("time.thread_time read")


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "solo"])
@pytest.mark.parametrize("kind", ["single", "sharded"])
def test_no_tracer_reads_no_cpu_clock(kind, stacked, monkeypatch):
    monkeypatch.setattr(time, "thread_time", _raise)
    _, traces, results = _serve(kind, stacked, None)
    assert traces == []
    assert [len(r) for r in results] == [N_ROWS] * len(results)


def test_the_cpu_clock_patch_reaches_a_traced_request(monkeypatch):
    """The patch of the test above is seen by the serving path: a traced
    request reads the clock, so it fails."""
    srv = SPARQLServer(_engine("single", Tracer()), max_batch=1)
    try:
        srv.query(TEXT)
        monkeypatch.setattr(time, "thread_time", _raise)
        with pytest.raises(Exception, match="thread_time"):
            srv.query(TEXT)
    finally:
        srv.close()
