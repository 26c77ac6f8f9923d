"""The result decode: `QueryEngine._decode_numpy` gathers a result's ids
through the dictionary's term table (`TermDict.decode_ids`) and zips the
columns into row dicts. Held here to the per-row loop it replaced, kept
below as the reference: equal rows, row order and key order; an OPTIONAL
group's unbound cells omitted, never gathered. Also the served path
(`ResultSet.rows` and the `decode` span's `unbound_rows`) and the term
table under concurrent decodes and encodes."""
import gc
import os
import sys
import threading
import time

import numpy as np
import pytest

from repro_torch.core.relation import UNBOUND
from repro_torch.obs import Tracer
from repro_torch.serve.sparql_server import SPARQLServer
from repro_torch.sparql.dictionary import TermDict
from repro_torch.sparql.engine import QueryEngine
from repro_torch.sparql.store import store_from_string_triples

SCHEMA = ("a", "b", "c", "d", "e", "f", "g")
OPTIONAL_TEXT = "SELECT ?x ?y ?o WHERE { ?x <p0> ?y . OPTIONAL { ?x <p1> ?o } }"
BGP_TEXT = "SELECT ?x ?z WHERE { ?x <p0> ?y . ?y <q> ?z . }"


def old_decode(d, schema, rows):
    """The per-row loop the gather replaced: one `decode` per bound cell."""
    return [
        {v: d.decode(int(t)) for v, t in zip(schema, row) if int(t) != UNBOUND}
        for row in rows
    ]


def _triples():
    triples = []
    for i in range(10):
        triples.append((f"<s{i}>", "<p0>", f"<m{i % 3}>"))
        if i % 2:
            triples.append((f"<s{i}>", "<p1>", f"<o{i}>"))
    for j in range(3):
        triples.append((f"<m{j}>", "<q>", f"<z{j}>"))
        triples.append((f"<m{j}>", "<q>", f"<z{j + 3}>"))
    return triples


def _engine(tracer=None) -> QueryEngine:
    store = store_from_string_triples(_triples())
    return QueryEngine(store, device="cpu", tracer=tracer)


def _assert_same(got, want):
    assert type(got) is list and all(type(r) is dict for r in got)
    assert got == want
    assert [list(r) for r in got] == [list(r) for r in want]  # key order


def _ids(n_terms, shape, seed, unbound_share=0.0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_terms, size=shape).astype(np.int32)
    if shape[0] > 1 and shape[-1]:
        ids[0, 0], ids[-1, -1] = 0, n_terms - 1
    if unbound_share:
        ids[rng.random(shape) < unbound_share] = UNBOUND
    return ids


def _case(name, n):
    """(schema, ids) of one named case over a dictionary of `n` terms."""
    if name.startswith("cols"):
        k = int(name[4:])
        return SCHEMA[:k], _ids(n, (23, k), k)
    if name == "empty":
        return SCHEMA[:3], np.zeros((0, 3), np.int32)
    if name == "empty_no_cols":
        return (), np.zeros((0, 0), np.int32)
    if name == "first_and_last":
        return SCHEMA[:2], np.array([[0, n - 1], [n - 1, 0]] * 3, np.int32)
    if name == "last_beside_unbound":
        # an unmasked -1 would decode to the last term, id n - 1
        return SCHEMA[:3], np.array(
            [[n - 1, UNBOUND, 0], [UNBOUND, n - 1, UNBOUND], [0, 1, n - 1]],
            np.int32)
    if name == "column_unbound":
        ids = _ids(n, (17, 3), 7)
        ids[:, 1] = UNBOUND
        return SCHEMA[:3], ids
    if name == "all_unbound":
        return SCHEMA[:2], np.full((5, 2), UNBOUND, np.int32)
    if name == "optional_mixed":
        return SCHEMA[:4], _ids(n, (61, 4), 11, unbound_share=0.2)
    if name == "strided":
        return SCHEMA[:3], _ids(n, (40, 6), 13)[::2, ::2]
    raise ValueError(name)


CASES = ["cols0", "cols1", "cols2", "cols3", "cols4", "cols7", "empty",
         "empty_no_cols", "first_and_last", "last_beside_unbound",
         "column_unbound", "all_unbound", "optional_mixed", "strided"]


@pytest.mark.parametrize("name", CASES)
def test_decode_equals_the_per_row_loop(name):
    eng = _engine()
    d = eng.store.dictionary
    schema, ids = _case(name, len(d))
    _assert_same(eng._decode_numpy(schema, ids), old_decode(d, schema, ids))


@pytest.mark.parametrize("new_terms", [1, 200], ids=["in_room", "regrown"])
def test_decode_after_new_terms_extends_the_table(new_terms):
    eng = _engine()
    d = eng.store.dictionary
    schema, ids = _case("optional_mixed", len(d))
    _assert_same(eng._decode_numpy(schema, ids), old_decode(d, schema, ids))
    before = len(d)
    for i in range(new_terms):
        d.encode(f"<new{i}>")
    schema, ids = _case("optional_mixed", len(d))
    ids[1, :] = [before, len(d) - 1, 0, len(d) - 1]  # the new terms
    _assert_same(eng._decode_numpy(schema, ids), old_decode(d, schema, ids))
    assert len(d._table) == len(d)


@pytest.mark.parametrize("lane", [0, 2])
def test_a_stacked_lanes_slice(lane):
    """What `PendingDecode.resolve` decodes of a stacked chunk: one
    lane's columns at that lane's valid rows."""
    eng = _engine()
    d = eng.store.dictionary
    cols = _ids(len(d), (3, 32, 3), 5, unbound_share=0.1)
    valid = np.random.default_rng(6).random((3, 32)) < 0.6
    rows = cols[lane][valid[lane]]
    _assert_same(eng._decode_numpy(SCHEMA[:3], rows),
                 old_decode(d, SCHEMA[:3], rows))


def test_bound_rows_are_built_without_young_collections():
    """Rows with every cell bound are built in C: the collector runs at
    most once or twice in a decode, not once every 700 new dicts, which
    would move the plan programs then in flight into the old generation
    (with the device memory their reference cycles hold)."""
    eng = _engine()
    d = eng.store.dictionary
    ids = _ids(len(d), (7000, 3), 17)
    starts = []

    def count(phase, info):
        if phase == "start":
            starts.append(info["generation"])

    gc.callbacks.append(count)
    try:
        rows = eng._decode_numpy(SCHEMA[:3], ids)
    finally:
        gc.callbacks.remove(count)
    assert len(rows) == 7000
    assert len(starts) <= 2, starts


def test_decode_ids_gathers_every_shape():
    d = TermDict()
    terms = [f"<t{i}>" for i in range(9)]
    assert d.encode_many(terms) == list(range(9))
    ids = np.arange(9, dtype=np.int32).reshape(3, 3)[::-1]
    out = d.decode_ids(ids)
    assert out.shape == (3, 3) and out.dtype == object
    assert out.tolist() == [[terms[i] for i in row] for row in ids.tolist()]
    with pytest.raises(IndexError):
        d.decode_ids(np.array([9], np.int32))


def _served(text, n):
    """`n` concurrent requests of `text` after a warm one, through a
    traced server whose decode records each call's ids; returns (the
    results, their traces, the recorded calls, the engine)."""
    eng = _engine(Tracer(ring_size=64))
    calls = []
    lock = threading.Lock()
    real = eng._decode_numpy

    def recording(schema, rows):
        out = real(schema, rows)
        with lock:
            calls.append((schema, rows.copy(), out))
        return out

    eng._decode_numpy = recording
    srv = SPARQLServer(eng, max_batch=n, max_wait_s=5.0)
    try:
        srv.query(text)
        results = [None] * n

        def one(k):
            results[k] = srv.query(text)

        threads = [threading.Thread(target=one, args=(k,)) for k in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
        return results, srv.recent_traces()[1:], calls, eng
    finally:
        srv.close()


def test_served_optional_rows_and_unbound_rows():
    results, traces, calls, eng = _served(OPTIONAL_TEXT, 4)
    d = eng.store.dictionary
    for schema, rows, out in calls:
        _assert_same(out, old_decode(d, schema, rows))
    unmatched = sum(1 for r in results[0].rows if "?o" not in r)
    assert 0 < unmatched < len(results[0].rows)
    for res in results:
        assert res.rows == results[0].rows
        assert all(list(r) == [v for v in ("?x", "?y", "?o") if v in r]
                   for r in res.rows)
    assert len(traces) == len(results)
    for t in traces:
        (decode,) = t.find("decode")
        assert decode.attrs["unbound_rows"] == unmatched


def test_served_bgp_reads_no_unbound_rows():
    results, traces, calls, eng = _served(BGP_TEXT, 4)
    d = eng.store.dictionary
    for schema, rows, out in calls:
        _assert_same(out, old_decode(d, schema, rows))
    assert len(traces) == len(results)
    for t in traces:
        (decode,) = t.find("decode")
        assert decode.attrs["unbound_rows"] == 0
        assert decode.attrs["rows"] == len(results[0].rows) > 0


def test_term_table_under_concurrent_decodes_and_encodes():
    """More decoding threads than cores, the switch interval at its
    shortest, while another thread encodes new terms: every decoded term
    is the dictionary's own for its id."""
    d = TermDict()
    d.encode_many(f"<seed{i}>" for i in range(64))
    stop = threading.Event()
    errors = []
    checked = [0]
    lock = threading.Lock()

    def encoder():
        i = 0
        while not stop.is_set():
            d.encode(f"<grown{i}>")
            i += 1

    def decoder(seed):
        rng = np.random.default_rng(seed)
        n_checked = 0
        try:
            while not stop.is_set():
                ids = rng.integers(0, len(d), size=32).astype(np.int32)
                got = d.decode_ids(ids).tolist()
                want = [d.decode(i) for i in ids.tolist()]
                if got != want:
                    errors.append((ids, got, want))
                    return
                n_checked += 1
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)
        with lock:
            checked[0] += n_checked

    n_decoders = (os.cpu_count() or 1) + 2
    threads = [threading.Thread(target=encoder)] + [
        threading.Thread(target=decoder, args=(s,)) for s in range(n_decoders)
    ]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        time.sleep(1.0)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[0]
    assert checked[0] > 0
    assert len(d) > 64
    assert d.decode_ids(np.arange(len(d))).tolist() == d._id_to_term
