"""The port's stacked batches against the reference's: `lower_batched`
per-lane arrays bit for bit (padding lanes and broadcast scans included),
and `run_batch` — widths, dispatches, compiles, fallbacks, padding and rows
— against the JAX engine's `last_batch` on identical stores. Also that no
op on the stacked path falls back to torch's per-lane loop (vmap's
"performance drop" warning is an error here)."""
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine_default import QUERIES, store_pair
from repro.core import executor as j_ex
from repro.core.relation import Relation as JRelation
from repro.sparql.engine import QueryEngine as JEngine
from repro.sparql.store import store_from_string_triples as j_store
from repro_torch.core import executor as t_ex
from repro_torch.core.relation import Relation as TRelation
from repro_torch.sparql.engine import QueryEngine as TEngine
from repro_torch.sparql.store import store_from_string_triples as t_store

LANE_LOOP = ".*performance drop.*"


@pytest.fixture(autouse=True)
def no_lane_loops():
    """torch.func.vmap warns "performance drop" when an op has no batching
    rule and it loops over the lanes instead: an error on the stacked path."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=LANE_LOOP)
        yield


# ------------------------------------------------------------ stores

def chain_triples(n_src=12, fan=3):
    """?x <p> ?y . ?y <q> ?z chains plus numeric attributes for FILTER
    (the reference's tests/test_batched_exec.py chain_store)."""
    triples = []
    for i in range(n_src):
        triples.append((f"<s{i}>", "<p>", f"<m{i % fan}>"))
        triples.append((f"<s{i}>", "<age>", str(20 + i)))
    for j in range(fan):
        triples.append((f"<m{j}>", "<q>", f"<z{j}>"))
        triples.append((f"<m{j}>", "<q>", f"<z{j + fan}>"))
    return triples


def overflow_triples():
    """One shape whose join total is 8 for <p1> and 56 for <p2>."""
    triples = [(f"<s{i}>", "<p1>", "<m1>") for i in range(8)]
    triples.append(("<m1>", "<qq>", "<z0>"))
    triples += [(f"<t{i}>", "<p2>", "<m2>") for i in range(8)]
    triples += [("<m2>", "<qq>", f"<w{j}>") for j in range(7)]
    return triples


def padding_triples():
    """Two predicates in different pow-2 scan buckets (near-miss shapes)."""
    triples = [(f"<s{i}>", "<small>", f"<m{i % 3}>") for i in range(12)]
    triples += [(f"<a{i}>", "<big>", f"<m{i % 3}>") for i in range(150)]
    triples += [(f"<m{j}>", "<q>", f"<z{j}>") for j in range(3)]
    return triples


def same_shape_queries(n):
    return [
        "SELECT ?x ?z WHERE { ?x <p> ?y . ?y <q> ?z . "
        f"FILTER (?x != <s{k}>) }}"
        for k in range(n)
    ]


SMALL = "SELECT ?x ?z WHERE { ?x <p1> ?y . ?y <qq> ?z . }"
BIG = "SELECT ?x ?z WHERE { ?x <p2> ?y . ?y <qq> ?z . }"
PAD = [
    "SELECT ?x ?z WHERE { ?x <small> ?y . ?y <q> ?z . }",
    "SELECT ?x ?z WHERE { ?x <big> ?y . ?y <q> ?z . }",
]


# -------------------------------------------------- run_batch scenarios
# Each scenario drives one engine through a sequence of batches and returns
# what it observed; the JAX engine and the port must observe the same.

def observe(eng, outcomes):
    groups = [
        (g.n_queries, g.widths, g.n_dispatches, g.n_compiles, g.cold,
         g.fallback, g.n_broadcast_scans, g.padded, g.n_shapes)
        for g in eng.last_batch
    ]
    slots = []
    for oc in outcomes:
        if isinstance(oc, Exception):
            slots.append(type(oc).__name__)
        else:
            st = oc.stats
            slots.append((oc.rows, st.batch_width, st.n_dispatches,
                          st.n_compiles, st.n_retries, st.join_totals,
                          st.join_caps))
    return groups, slots


def sc_warm_same_shape(eng, _):
    ps = [eng.prepare(t) for t in same_shape_queries(8)]
    seq = [p.run().rows for p in ps]
    return [seq, observe(eng, eng.run_batch(ps)),
            observe(eng, eng.run_batch(ps))]


def sc_chunking(eng, _):
    ps = [eng.prepare(t) for t in same_shape_queries(10)]
    [p.run() for p in ps]
    return [observe(eng, eng.run_batch(ps)), observe(eng, eng.run_batch(ps))]


def sc_padding_lanes(eng, _):
    ps = [eng.prepare(t) for t in same_shape_queries(5)]
    first = observe(eng, eng.run_batch(ps))
    six = [eng.prepare(t) for t in same_shape_queries(6)]
    return [first, observe(eng, eng.run_batch(six))]


def sc_cold_group(eng, _):
    ps = [eng.prepare(t) for t in same_shape_queries(7)]
    return [observe(eng, eng.run_batch(ps))]


def sc_mixed(eng, _):
    a = [eng.prepare(t) for t in same_shape_queries(4)]
    b = [eng.prepare("SELECT ?x ?a WHERE { ?x <p> ?y . ?x <age> ?a . }")
         for _ in range(3)]
    [p.run() for p in a + b]
    mixed = [a[0], b[0], a[1], b[1], a[2], b[2], a[3]]
    return [observe(eng, eng.run_batch(mixed))]


def sc_single(eng, _):
    pq = eng.prepare(same_shape_queries(1)[0])
    pq.run()
    return [observe(eng, eng.run_batch([pq])), eng.stacked_dispatches]


def sc_overflow_regrow(eng, _):
    ps, pb = eng.prepare(SMALL), eng.prepare(BIG)
    ps.run()
    return [observe(eng, eng.run_batch([ps, pb])),
            observe(eng, eng.run_batch([ps, pb]))]


def sc_max_capacity_isolation(eng, _):
    ok, boom = eng.prepare(SMALL), eng.prepare(BIG)
    ok.run()
    return [observe(eng, eng.run_batch_outcomes([ok, boom, ok]))]


def sc_counters(eng, _):
    ps = [eng.prepare(t) for t in same_shape_queries(8)]
    [p.run() for p in ps]
    eng.run_batch(ps)
    eng.run_batch(ps[:3])
    return [eng.stacked_dispatches, eng.stacked_queries, eng.batch_width_hist]


def sc_save_cache_widths(eng, tmp_path):
    ps = [eng.prepare(t) for t in same_shape_queries(6)]
    [p.run() for p in ps]
    eng.run_batch(ps)
    path = tmp_path / f"warm_{type(eng).__module__}.json"
    eng.save_cache(str(path))
    entry = json.loads(path.read_text())["entries"][0]
    eng2 = type(eng)(eng.store, warmup_path=str(path), **_device(eng))
    ps2 = [eng2.prepare(t) for t in same_shape_queries(6)]
    first = ps2[0].run()
    return [entry["widths"], entry["layouts"], first.stats.n_count_passes,
            first.stats.n_compiles, observe(eng2, eng2.run_batch(ps2))]


def sc_padded_stacking(eng, _):
    ps = [eng.prepare(t) for t in PAD for _ in range(4)]
    [p.run() for p in ps]
    return [observe(eng, eng.run_batch(ps)), eng.padded_groups,
            eng.pad_rejects, eng.padded_cells, eng.real_cells]


def sc_padding_cost_guard(eng, _):
    ps = [eng.prepare(t) for t in PAD for _ in range(4)]
    [p.run() for p in ps]
    return [observe(eng, eng.run_batch(ps)), eng.padded_groups,
            eng.pad_rejects]


def sc_padded_after_update(eng, _):
    ps = [eng.prepare(t) for t in PAD for _ in range(4)]
    [p.run() for p in ps]
    eng.run_batch(ps)
    eng.update("INSERT DATA { <s0> <small> <m1> . }")
    return [observe(eng, eng.run_batch(ps)), eng.padded_groups]


def _device(eng):
    return {"device": "cpu"} if isinstance(eng, TEngine) else {}


SCENARIOS = {
    "warm_same_shape": (sc_warm_same_shape, chain_triples, {}),
    "chunking": (sc_chunking, chain_triples, {"max_batch_width": 4}),
    "non_pow2_width_cap": (sc_chunking, chain_triples, {"max_batch_width": 6}),
    "padding_lanes": (sc_padding_lanes, chain_triples, {}),
    "cold_group": (sc_cold_group, chain_triples, {}),
    "mixed": (sc_mixed, chain_triples, {}),
    "single": (sc_single, chain_triples, {}),
    "eager_fallback": (sc_cold_group, chain_triples, {"compiled": False}),
    "overflow_regrow": (sc_overflow_regrow, overflow_triples, {}),
    "max_capacity_isolation": (sc_max_capacity_isolation, overflow_triples,
                               {"max_capacity": 16}),
    "counters": (sc_counters, chain_triples, {}),
    "save_cache_widths": (sc_save_cache_widths, chain_triples, {}),
    "padded_stacking": (sc_padded_stacking, padding_triples, {}),
    "padding_cost_guard": (sc_padding_cost_guard, padding_triples,
                           {"pad_waste_limit": 0.0}),
    "padded_after_update": (sc_padded_after_update, padding_triples, {}),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_run_batch_matches_reference(name, tmp_path):
    scenario, triples, kw = SCENARIOS[name]
    j_eng = JEngine(j_store(triples()), **kw)
    t_eng = TEngine(t_store(triples()), device="cpu", **kw)
    want = scenario(j_eng, tmp_path)
    got = scenario(t_eng, tmp_path)
    assert got == want


def test_batch_error_is_raised_by_run_batch():
    eng = TEngine(t_store(overflow_triples()), device="cpu", max_capacity=16)
    ok, boom = eng.prepare(SMALL), eng.prepare(BIG)
    ok.run()
    with pytest.raises(MemoryError):
        eng.run_batch([ok, boom])
    assert eng.last_batch[0].fallback


def test_stacked_dispatch_failure_other_than_memory_propagates(monkeypatch):
    """Only the engine's own MemoryError sends a stacked chunk to the
    sequential path; any other failure of the dispatch (on the card: a
    refused launch or a CUDA error) propagates out of run_batch."""
    eng = TEngine(t_store(chain_triples()), device="cpu")
    ps = [eng.prepare(t) for t in same_shape_queries(4)]
    [p.run() for p in ps]

    def refused(*args, **kwargs):
        raise RuntimeError("CUDA kernel 'pair_expand' failed to launch")

    monkeypatch.setattr(t_ex.CompiledBatch, "__call__", refused)
    with pytest.raises(RuntimeError, match="failed to launch"):
        eng.run_batch_outcomes(ps)
    assert not eng.last_batch[0].fallback


# --------------------------------------------- lower_batched, lane by lane

VARIANTS = {
    # (query, [(text to replace, replacements)]): same-shape lanes whose
    # scans differ per lane (stacked) or are shared (broadcast)
    "Q1": ("Course0_0_0", ["Course0_0_0", "Course0_0_1", "Course0_1_0"]),
    "Q4": ("Dept0_0", ["Dept0_0", "Dept0_1", "Dept0_2"]),
    "Q7": ("Prof0_0_0", ["Prof0_0_0", "Prof0_0_1", "Prof0_1_0"]),
    "F1": ("prof_0_0_0", ["prof_0_0_0", "prof_0_0_1", "nobody"]),
    "FO1": ("LIMIT 64", ["LIMIT 64", "LIMIT 5", "LIMIT 300"]),
    "S1": ("?z", ["?z", "?z", "?z"]),
    "O1": ("?a", ["?a", "?a", "?a"]),
    "U1": ("?v", ["?v", "?v", "?v"]),
    "J2": ("?d", ["?d", "?d", "?d"]),
}


@pytest.fixture(scope="module")
def lubm_stores():
    return store_pair()


def _warm_lanes(eng, texts):
    pqs = [eng.prepare(t) for t in texts]
    for pq in pqs:
        pq.run()
        pq.run()
    return pqs


# every shape on the optimizer's choice (S1 routes to the matrix backend),
# and the MR-routed shapes with OPTIONAL, UNION and a star forced to matrix
LANE_CASES = [(name, None) for name in VARIANTS] + [
    (name, "matrix") for name in ("Q4", "O1", "U1")
]


@pytest.mark.parametrize("name,backend", LANE_CASES)
def test_lower_batched_lanes_match_reference(lubm_stores, name, backend):
    """Three real lanes and one padding lane, at the port's natural scan
    layout (broadcast where every lane scans one pattern) and all-stacked:
    every array of every lane — padding lanes included — equals the JAX
    vmapped program's."""
    js, ts = lubm_stores
    old, subs = VARIANTS[name]
    texts = [QUERIES[name].replace(old, s) for s in subs]
    j_eng = JEngine(js, join_backend=backend)
    t_eng = TEngine(ts, device="cpu", join_backend=backend)
    j_pqs, t_pqs = _warm_lanes(j_eng, texts), _warm_lanes(t_eng, texts)
    ctxs = [t_eng._batch_context(pq._program) for pq in t_pqs]
    assert len({c.shape for c in ctxs}) == 1, "variants must share a shape"
    shape = ctxs[0].shape
    t_plan = t_eng.plan_cache.get(shape).compiled.plan
    _, j_shape, _ = j_eng._canonicalize(j_pqs[0]._program)
    j_plan = j_eng.plan_cache.get(j_shape).compiled.plan
    assert t_plan.join_caps == j_plan.join_caps
    inp = t_eng._stage_chunk(shape, ctxs + [ctxs[0]], 3)
    layouts = {inp.scan_axes, (0,) * len(inp.scans)}
    for axes in layouts:
        scans = tuple(
            s if a == ax else TRelation(
                s.schema, torch.stack([s.cols] * 4), torch.stack([s.valid] * 4)
            )
            for s, a, ax in zip(inp.scans, inp.scan_axes, axes)
        )
        got = t_ex.compile_plan_batched(t_plan, 4, axes)(
            scans, inp.consts_i, inp.consts_f, inp.num_vals, inp.active
        )
        j_scans = tuple(
            JRelation(s.schema, jnp.asarray(s.cols.numpy()),
                      jnp.asarray(s.valid.numpy()))
            for s in scans
        )
        want = jax.jit(j_ex.lower_batched(j_plan, scan_axes=axes))(
            j_scans, jnp.asarray(inp.consts_i.numpy()),
            jnp.asarray(inp.consts_f.numpy()), js.numeric_values_device(),
            jnp.asarray(inp.active.numpy()),
        )
        for g, w in ((got.relation.cols, want.relation.cols),
                     (got.relation.valid, want.relation.valid),
                     (got.totals, want.totals),
                     (got.overflows, want.overflows)):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype
            np.testing.assert_array_equal(g.numpy(), w)
        assert not got.relation.valid[3].any()  # the padding lane


def test_run_batch_rows_match_reference_on_lubm(lubm_stores):
    """Every LUBM shape, three copies each, in one mixed batch: rows equal
    the JAX engine's, with no lane loop."""
    js, ts = lubm_stores
    texts = [t for t in QUERIES.values() for _ in range(3)]
    j_eng = JEngine(js)
    t_eng = TEngine(ts, device="cpu")
    for eng in (j_eng, t_eng):
        eng.run_batch([eng.prepare(t) for t in QUERIES.values()])  # warm
    want = j_eng.run_batch([j_eng.prepare(t) for t in texts])
    got = t_eng.run_batch([t_eng.prepare(t) for t in texts])
    assert [r.rows for r in got] == [r.rows for r in want]
    assert t_eng.stacked_dispatches == j_eng.stacked_dispatches
    assert [g.widths for g in t_eng.last_batch] == [
        g.widths for g in j_eng.last_batch
    ]
