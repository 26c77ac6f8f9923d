"""The port's serving tier — MicroBatcher, DecodePool, SPARQLServer — on the
CPU: the behaviours of the reference's serving tests (decode-pool crash
isolation, abandoned requests, independent exception copies, typed
timeouts, per-request error isolation, stats), with rows held to the JAX
server's and to the NumPy oracle (`baseline.reference_rows`) under
concurrent submission."""
import threading
import time
import weakref

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import pytest
import torch  # noqa: F401

from repro.serve.sparql_server import SPARQLServer as JServer
from repro.sparql.baseline import reference_rows as j_reference_rows
from repro.sparql.engine import QueryEngine as JEngine
from repro.sparql.parser import parse as j_parse
from repro.sparql.store import store_from_string_triples as j_store
from repro_torch.serve.batcher import (
    BatchTimeout,
    Deferred,
    MicroBatcher,
    Request,
    _exc_copy,
)
from repro_torch.serve.decode import DecodePool
from repro_torch.serve.sparql_server import (
    ParseQueryError,
    QueryError,
    QueryResult,
    QueryTimeoutError,
    SPARQLServer,
)
from repro_torch.sparql.baseline import reference_rows
from repro_torch.sparql.engine import QueryEngine
from repro_torch.sparql.parser import parse
from repro_torch.sparql.store import store_from_string_triples


def rows_as_sets(rows):
    return sorted(tuple(sorted(r.items())) for r in rows)


def pipeline_triples():
    """Entities wired for every algebra shape: BGP chains, numeric FILTER,
    sparse OPTIONAL matches, UNION branches (the reference's
    pipeline_store)."""
    triples = []
    for i in range(10):
        triples.append((f"<s{i}>", "<p0>", f"<m{i % 3}>"))
        triples.append((f"<s{i}>", "<age>", str(18 + 2 * i)))
        if i % 2:
            triples.append((f"<s{i}>", "<p1>", f"<o{i}>"))
    for j in range(3):
        triples.append((f"<m{j}>", "<q>", f"<z{j}>"))
        triples.append((f"<m{j}>", "<q>", f"<z{j + 3}>"))
    return triples


QUERIES = [
    "SELECT ?x ?z WHERE { ?x <p0> ?y . ?y <q> ?z . }",
    "SELECT ?x ?a WHERE { ?x <p0> ?y . ?x <age> ?a . FILTER (?a > 24) }",
    "SELECT ?x ?y ?o WHERE { ?x <p0> ?y . OPTIONAL { ?x <p1> ?o } }",
    "SELECT ?x ?v WHERE { { ?x <p0> ?v } UNION { ?x <p1> ?v } }",
]


def _server(**kw):
    kw.setdefault("max_batch", 8)
    store = store_from_string_triples(pipeline_triples())
    return SPARQLServer(QueryEngine(store, device="cpu"), **kw)


def _dispatch(srv, texts):
    """The server's dispatch stage called directly, its Deferred slots
    resolved inline (what the batcher/decode pool does between stages)."""
    outs = []
    for o in srv._run_batch(texts):
        if isinstance(o, Deferred):
            try:
                o = o.fn()
            except Exception as e:
                o = e
        outs.append(o)
    return outs


# ------------------------------------------------------- decode pool unit

def test_decode_pool_isolates_crashes_and_counts():
    pool = DecodePool(n_workers=2, max_queue=8)
    try:
        ok, bad = Request("a"), Request("b")
        pool.submit(ok, lambda: "fine")
        pool.submit(bad, lambda: (_ for _ in ()).throw(RuntimeError("die")))
        assert ok.event.wait(5) and bad.event.wait(5)
        assert ok.result == "fine"
        assert isinstance(bad.result, RuntimeError)
        again = Request("c")  # the pool survived the crash
        pool.submit(again, lambda: 42)
        assert again.event.wait(5) and again.result == 42
        s = pool.stats()
        assert s["decoded"] == 2 and s["errors"] == 1
    finally:
        pool.close()


def test_decode_pool_skips_abandoned_requests():
    pool = DecodePool(n_workers=1, max_queue=8)
    try:
        r = Request("x")
        r.abandoned = True
        ran = []
        pool.submit(r, lambda: ran.append(1))
        assert r.event.wait(5)
        assert not ran and pool.stats()["skipped"] == 1
    finally:
        pool.close()


# ------------------------------------------------------------ batcher unit

def test_batch_failure_gives_each_request_an_independent_copy():
    def boom(payloads):
        raise ValueError("batch exploded")

    pool = DecodePool(n_workers=1, max_queue=8)
    b = MicroBatcher(boom, max_batch=4, decode_pool=pool, max_wait_s=0.05)
    try:
        errs, lock = [], threading.Lock()

        def hit():
            try:
                b.submit("q", timeout=10)
            except ValueError as e:
                with lock:
                    errs.append(e)

        ts = [threading.Thread(target=hit) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert len(errs) == 4
        assert len({id(e) for e in errs}) == 4  # independent instances
        for e in errs:
            frames, tb = [], e.__traceback__
            while tb is not None:
                frames.append(tb.tb_frame.f_code.co_name)
                tb = tb.tb_next
            assert "boom" in frames  # original raise site preserved
    finally:
        b.close()
        pool.close()


def test_exc_copy_falls_back_for_awkward_constructors():
    class Picky(Exception):
        def __init__(self, a, b):
            super().__init__(f"{a}/{b}")
            self.a = a

    try:
        raise Picky(1, 2)
    except Picky as e:
        orig = e
    c = _exc_copy(orig)
    assert c is not orig
    assert c.a == 1 and c.args == orig.args
    assert c.__traceback__ is orig.__traceback__


def test_batcher_timeout_marks_request_abandoned():
    gate = threading.Event()

    def slow(payloads):
        gate.wait(5)
        return [Deferred(lambda: "late") for _ in payloads]

    pool = DecodePool(n_workers=1, max_queue=8)
    b = MicroBatcher(slow, max_batch=2, decode_pool=pool, max_wait_s=0.001)
    try:
        with pytest.raises(BatchTimeout):
            b.submit("q", timeout=0.05)
        gate.set()
        deadline = time.monotonic() + 5
        while pool.stats()["skipped"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        # the pool dropped the abandoned slot without decoding it
        assert pool.stats()["skipped"] == 1
        assert pool.stats()["decoded"] == 0
    finally:
        gate.set()
        b.close()
        pool.close()


# ------------------------------------------------------------ server paths

def test_query_timeout_raises_typed_error_and_counts():
    srv = _server()
    try:
        try:
            srv.query(QUERIES[0], timeout_ms=0.0001)
        except QueryTimeoutError as e:
            assert e.kind == "timeout" and isinstance(e, TimeoutError)
        assert len(srv.query(QUERIES[0])) > 0  # later requests still served
        assert srv.stats()["timeouts"] <= 1
    finally:
        srv.close()


def test_server_batch_coalesces_and_isolates_errors():
    srv = _server()
    try:
        texts = [f"SELECT ?x ?z WHERE {{ ?x <p0> ?y . ?y <q> ?z . "
                 f"FILTER (?x != <s{k}>) }}" for k in range(4)]
        _dispatch(srv, texts)  # warms plan + stacked caches
        outs = _dispatch(srv, [texts[0], "SELECT NONSENSE", *texts[1:]])
        assert isinstance(outs[1], ParseQueryError)
        good = [o for i, o in enumerate(outs) if i != 1]
        assert all(isinstance(o, QueryResult) for o in good)
        assert srv.engine.last_batch[0].n_dispatches == 1
        assert srv.engine.last_batch[0].widths == (4,)
        want = [srv.engine.prepare(t).run().rows for t in texts]
        assert [o.rows for o in good] == want
        s = srv.stats()["batched"]
        assert s["stacked_dispatches"] == 2 and s["queries_per_dispatch"] > 1
        assert s["batch_width_hist"] == {4: 2}
    finally:
        srv.close()


def test_server_dispatch_defers_every_dispatched_slot():
    """The dispatch stage returns a Deferred for every query it dispatched
    (cold calibration runs included) and a typed error for the rest: no
    row decode runs on the batcher thread."""
    srv = _server()
    try:
        outs = srv._run_batch([*QUERIES, "SELECT NONSENSE"])
        assert all(isinstance(o, Deferred) for o in outs[:-1])
        assert isinstance(outs[-1], ParseQueryError)
        for t, o in zip(QUERIES, outs):
            assert rows_as_sets(o.fn().rows) == rows_as_sets(
                reference_rows(srv.engine.store, parse(t))
            )
    finally:
        srv.close()


def test_decode_worker_crash_is_isolated_and_server_survives():
    srv = _server()
    try:
        srv.query(QUERIES[0])
        real = srv.engine._decode_numpy
        crashed = []

        def sabotage(schema, rows):
            if not crashed:
                crashed.append(1)
                raise RuntimeError("decode worker crash")
            return real(schema, rows)

        srv.engine._decode_numpy = sabotage
        try:
            with pytest.raises(QueryError) as e:
                srv.query(QUERIES[0])
            assert e.value.kind == "decode"
        finally:
            srv.engine._decode_numpy = real
        out = srv.query(QUERIES[0])
        assert isinstance(out, QueryResult) and len(out) > 0
        assert srv.stats()["pipeline"]["decode"]["errors"] >= 1
    finally:
        srv.close()


def test_cold_query_resolves_through_the_decode_pool():
    srv = _server()
    try:
        out = srv.query(QUERIES[0])
        assert isinstance(out, QueryResult)
        assert rows_as_sets(out.rows) == rows_as_sets(
            reference_rows(srv.engine.store, parse(QUERIES[0]))
        )
        st = srv.stats()["pipeline"]
        assert st["deferred"] == 1
        assert st["decode"]["workers"] == srv.decode_workers
        assert st["decode"]["decoded"] == 1
    finally:
        srv.close()


def _both_servers(triples, engine_kw=None, **kw):
    """The reference's server and the port's over the same triples."""
    engine_kw = engine_kw or {}
    return (
        JServer(JEngine(j_store(triples), **engine_kw), **kw),
        SPARQLServer(QueryEngine(store_from_string_triples(triples),
                                 device="cpu", **engine_kw), **kw),
    )


def _dispatch_either(srv, texts):
    """_dispatch for either package's server: each package's Deferred
    slots resolved inline."""
    return [o.fn() if type(o).__name__ == "Deferred" else o
            for o in srv._run_batch(texts)]


def _concurrent(srv, texts):
    """Every text submitted at once from its own thread: the rows of each."""
    rows = [None] * len(texts)
    gate = threading.Barrier(len(texts))

    def ask(i):
        gate.wait()
        rows[i] = srv.query(texts[i]).rows

    threads = [threading.Thread(target=ask, args=(i,))
               for i in range(len(texts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    return rows


def test_synchronous_mode_matches_jax_server():
    """decode_workers=0 (test_serving_pipeline.py:287-300): no pool, decode
    inline on the batcher thread, the reference's rows and the oracle's,
    alone and under concurrent submission."""
    triples = pipeline_triples()
    servers = _both_servers(triples, decode_workers=0, max_wait_s=0.02)
    try:
        j_srv, srv = servers
        for t in QUERIES:
            out = srv.query(t)
            assert isinstance(out, QueryResult)
            assert out.rows == j_srv.query(t).rows
            assert rows_as_sets(out.rows) == rows_as_sets(
                reference_rows(srv.engine.store, parse(t))
            )
        texts = [QUERIES[i % len(QUERIES)] for i in range(12)]
        assert _concurrent(srv, texts) == _concurrent(j_srv, texts)
        for s in servers:
            st = s.stats()["pipeline"]
            assert st["decode"] is None and st["deferred"] >= len(texts)
        assert srv.stats()["pipeline"]["deferred"] == (
            j_srv.stats()["pipeline"]["deferred"]
        )
    finally:
        for s in servers:
            s.close()


def _chain_triples(n_src=12, fan=3):
    """test_batched_exec.py's chain store."""
    triples = []
    for i in range(n_src):
        triples.append((f"<s{i}>", "<p>", f"<m{i % fan}>"))
        triples.append((f"<s{i}>", "<age>", str(20 + i)))
    for j in range(fan):
        triples.append((f"<m{j}>", "<q>", f"<z{j}>"))
        triples.append((f"<m{j}>", "<q>", f"<z{j + fan}>"))
    return triples


def test_unbatched_server_matches_jax_server():
    """batch_execution=False (test_batched_exec.py:375-384): each pending
    query runs alone, nothing is stacked, the rows are the reference's."""
    texts = [
        "SELECT ?x ?z WHERE { ?x <p> ?y . ?y <q> ?z . "
        f"FILTER (?x != <s{k}>) }}"
        for k in range(4)
    ]
    servers = _both_servers(_chain_triples(), batch_execution=False)
    try:
        rows = []
        for s in servers:
            _dispatch_either(s, texts)
            outs = _dispatch_either(s, texts)
            assert s.engine.stacked_dispatches == 0
            assert s.stats()["batched"]["stacked_dispatches"] == 0
            rows.append([o.rows for o in outs])
        assert rows[1] == rows[0]
        # the batched server stacks the same batch
        srv = SPARQLServer(QueryEngine(
            store_from_string_triples(_chain_triples()), device="cpu"))
        try:
            _dispatch(srv, texts)
            assert [o.rows for o in _dispatch(srv, texts)] == rows[0]
            assert srv.engine.stacked_dispatches > 0
        finally:
            srv.close()
    finally:
        for s in servers:
            s.close()


def test_unbatched_server_keeps_each_failure_as_its_outcome():
    """batch_execution=False: one query's MemoryError (double-on-overflow
    past max_capacity) is its own outcome, an execution QueryError, and
    its batchmate answers, in both packages."""
    triples = ([(f"<s{i}>", "<p>", "<hub>") for i in range(20)]
               + [("<hub>", "<q>", f"<o{i}>") for i in range(20)]
               + [(f"<s{i}>", "<age>", str(i)) for i in range(4)])
    texts = ["SELECT ?x ?a WHERE { ?x <p> ?y . ?x <age> ?a . }",
             "SELECT ?x ?z WHERE { ?x <p> ?y . ?y <q> ?z . }"]
    servers = _both_servers(
        triples, {"exact_count_pass": False, "max_capacity": 64},
        batch_execution=False,
    )
    try:
        outs = []
        for s in servers:
            outs.append(_dispatch_either(s, texts))
            assert s.engine.stacked_dispatches == 0
        (j_ok, j_bad), (ok, bad) = outs
        assert ok.rows == j_ok.rows and len(ok.rows) == 4
        assert isinstance(bad, QueryError) and bad.kind == "execution"
        assert type(j_bad).__name__ == "QueryError"
        assert j_bad.kind == "execution"
    finally:
        for s in servers:
            s.close()


def test_update_through_server_is_seen_by_later_queries():
    srv = _server()
    try:
        before = len(srv.query(QUERIES[0]))
        res = srv.update("INSERT DATA { <s99> <p0> <m0> . }")
        assert res.inserted == 1
        assert len(srv.query(QUERIES[0])) == before + 2  # m0 has two <q>
        assert srv.stats()["updates"]["rows_inserted"] == 1
        with pytest.raises(ParseQueryError):
            srv.update("INSERT NONSENSE")
    finally:
        srv.close()


def test_pipelined_results_match_jax_server_and_oracle_concurrent():
    """Acceptance: 32 concurrent requests through the pipelined port server
    — BGP/FILTER/OPTIONAL/UNION with two mid-batch parse errors — return
    the JAX server's rows for the same requests and the NumPy oracle's;
    the parse errors stay with their own callers."""
    triples = pipeline_triples()
    j_srv = JServer(JEngine(j_store(triples)), max_batch=8)
    try:
        want = {t: j_srv.query(t).rows for t in QUERIES}
    finally:
        j_srv.close()
    srv = _server(max_wait_s=0.02)
    store = srv.engine.store
    for t in QUERIES:
        oracle = rows_as_sets(reference_rows(store, parse(t)))
        assert rows_as_sets(want[t]) == oracle
        assert oracle == rows_as_sets(
            j_reference_rows(j_store(triples), j_parse(t))
        )
    try:
        n, bad_at = 32, {5, 17}
        plan = [QUERIES[i % len(QUERIES)] for i in range(n)]
        results, errors = [None] * n, [None] * n

        def hit(i):
            try:
                results[i] = srv.query("BROKEN {" if i in bad_at else plan[i])
            except Exception as e:
                errors[i] = e

        ts = [threading.Thread(target=hit, args=(i,)) for i in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        for i in range(n):
            if i in bad_at:
                assert isinstance(errors[i], ParseQueryError), errors[i]
            else:
                assert isinstance(results[i], QueryResult), errors[i]
                assert results[i].rows == want[plan[i]]
        st = srv.stats()
        assert st["pipeline"]["deferred"] > 0
        assert st["pipeline"]["decode"]["decoded"] > 0
        assert st["pipeline"]["decode"]["errors"] == 0
        assert st["batched"]["stacked_dispatches"] > 0
    finally:
        srv.close()


def test_traced_requests_close_every_span():
    """With a Tracer on the engine, every request's trace is finished with
    zero open spans, and stacked lanes share their dispatch span's id."""
    from repro_torch.obs import Tracer

    store = store_from_string_triples(pipeline_triples())
    srv = SPARQLServer(
        QueryEngine(store, device="cpu", tracer=Tracer(ring_size=256)),
        max_batch=8, max_wait_s=0.05,
    )
    try:
        for t in QUERIES:
            srv.query(t)
        ts = [threading.Thread(target=srv.query, args=(QUERIES[0],))
              for _ in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        traces = srv.recent_traces()
        assert len(traces) == len(QUERIES) + 6
        assert srv.engine.tracer.open_span_count() == 0
        names = {s.name for t in traces for s in t.spans}
        assert {"parse", "dispatch", "transfer", "decode"} <= names
    finally:
        srv.close()


class _Payload:
    """A weak-referenceable stand-in for a large decoded result."""


def _released(ref, within_s: float = 2.0) -> bool:
    deadline = time.monotonic() + within_s
    while ref() is not None and time.monotonic() < deadline:
        time.sleep(0.01)
    return ref() is None


def test_finished_requests_are_not_pinned_by_the_pipeline():
    """Once a request is answered, neither the decode worker nor the
    batcher thread keeps its result alive: freeing a large result must not
    fall to whichever request those threads handle next (a 254k-row
    decode freed that way delayed the next burst by ~160 ms on the card)."""
    pool = DecodePool(n_workers=1, max_queue=8)
    try:
        r = Request("x")
        pool.submit(r, _Payload)
        assert r.event.wait(5)
        ref = weakref.ref(r.result)
        del r
        assert _released(ref), "the decode worker pins its last result"
    finally:
        pool.close()
    pool = DecodePool(n_workers=1, max_queue=8)
    b = MicroBatcher(lambda payloads: [_Payload() for _ in payloads],
                     max_batch=4, decode_pool=pool, max_wait_s=0.001)
    try:
        ref = weakref.ref(b.submit("q", timeout=5))
        assert _released(ref), "the batcher thread pins its last batch"
    finally:
        b.close()
        pool.close()
