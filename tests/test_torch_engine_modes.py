"""The engine's configuration modes in the port (device="cpu") against the
reference's on the same seeded stores: the legacy greedy planner
(`optimize=False`), double-on-overflow join sizing
(`exact_count_pass=False`), the stacking knobs (`pad_stacking`,
`pad_waste_limit`; `max_batch_width` runs in test_torch_batched.py), the
stacked-scan cache's size, every reference configuration field, and the
sharded engine on the legacy plan.

Rows are compared in order (the decoded rows of both engines) and these
ExecStats must be equal: peak_join_bucket, n_count_passes, n_retries,
n_dispatches and n_compiles. The reference's stores come from its own
tests' store helpers; the port's store is built from their triples and term
list."""
import dataclasses

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch  # noqa: F401

from test_batched_exec import chain_store
from test_optimizer import (
    _filter_order_store,
    _mini_store,
    _query_text,
    student_store,
)
from test_serving_pipeline import PAD_QUERIES, padding_store
from test_torch_engine_default import QUERIES
from repro.core import plan_ir as j_plan_ir
from repro.core.planner import TriplePattern as JPattern
from repro.serve.sparql_server import SPARQLServer as JServer
from repro.sparql import lubm as j_lubm
from repro.sparql.baseline import reference_rows
from repro.sparql.engine import QueryEngine as JEngine
from repro.sparql.engine import ShardedQueryEngine as JShardedEngine
from repro.sparql.parser import Query as JQuery
from repro.sparql.parser import parse as j_parse
from repro.sparql.sharded_store import ShardedTripleStore as JShardedStore
from repro.sparql.store import TripleStore as JStore
from repro.sparql.store import store_from_string_triples as j_store
from repro_torch.core import plan_ir as t_plan_ir
from repro_torch.core.planner import TriplePattern as TPattern
from repro_torch.serve.sparql_server import SPARQLServer as TServer
from repro_torch.sparql.engine import QueryEngine as TEngine
from repro_torch.sparql.engine import ShardedQueryEngine as TShardedEngine
from repro_torch.sparql.parser import Query as TQuery
from repro_torch.sparql.parser import parse as t_parse
from repro_torch.sparql.sharded_store import ShardedTripleStore as TShardedStore
from repro_torch.sparql.sharded_store import shard_store
from repro_torch.sparql.store import TripleStore
from repro_torch.sparql.store import store_from_string_triples as t_store

STAT_FIELDS = ("peak_join_bucket", "n_count_passes", "n_retries",
               "n_dispatches", "n_compiles")


def stats_of(st) -> dict:
    return {f: getattr(st, f) for f in STAT_FIELDS}


def rows_as_sets(rows):
    return sorted(tuple(sorted(r.items())) for r in rows)


def port_store(js) -> TripleStore:
    """The port's store over a reference store's triples and terms."""
    terms = [js.dictionary.decode(i) for i in range(len(js.dictionary))]
    return TripleStore.from_arrays(js.triples, terms)


def engine_pair(js, **kw):
    return JEngine(js, **kw), TEngine(port_store(js), device="cpu", **kw)


def run_pair(engines, text: str):
    """One run on each engine: equal rows in order, equal ExecStats."""
    je, te = engines
    a = je.prepare(text).run()
    b = te.prepare(text).run()
    assert b.rows == a.rows, text
    assert stats_of(b.stats) == stats_of(a.stats), text
    return a, b


# ------------------------------------------------ the configuration fields

# reference fields the port has no counterpart for: `use_kernel` (the card
# always runs the hand-written kernels) and `row_sharding` (a JAX sharding)
NOT_PORTED = {"use_kernel", "row_sharding"}


@pytest.mark.parametrize("ref, port", [
    (JEngine, TEngine),
    (JShardedEngine, TShardedEngine),
    (JStore, TripleStore),
    (JShardedStore, TShardedStore),
    (JServer, TServer),
], ids=["QueryEngine", "ShardedQueryEngine", "TripleStore",
        "ShardedTripleStore", "SPARQLServer"])
def test_port_takes_every_reference_field_with_its_default(ref, port):
    want = {f.name: f for f in dataclasses.fields(ref)}
    got = {f.name: f for f in dataclasses.fields(port)}
    assert set(want) - set(got) <= NOT_PORTED
    for name in set(want) & set(got):
        assert got[name].default == want[name].default, name


# ------------------------------------------- the legacy greedy planner


@pytest.fixture(scope="module")
def j_stores():
    js = j_lubm.generate(scale=1, seed=0, join_shapes=True)
    return js, port_store(js)


@pytest.mark.parametrize("name", ["J1", "J2"])
def test_greedy_and_optimized_j_shapes_match_reference(j_stores, name):
    """test_optimizer.py's J1/J2 acceptance in both packages: greedy and
    optimized rows equal, the optimized bucket at most 1/8 of greedy's,
    each bucket the reference's, warm 1 dispatch and 0 compiles."""
    js, ts = j_stores
    text = j_lubm.J_QUERIES[name]
    greedy = (JEngine(js, optimize=False),
              TEngine(ts, device="cpu", optimize=False))
    optimized = (JEngine(js), TEngine(ts, device="cpu"))
    _, rg = run_pair(greedy, text)
    _, rs = run_pair(optimized, text)
    assert rows_as_sets(rg.rows) == rows_as_sets(rs.rows)
    assert rs.stats.peak_join_bucket * 8 <= rg.stats.peak_join_bucket
    for pair in (greedy, optimized):
        _, warm = run_pair(pair, text)
        assert warm.stats.n_dispatches == 1 and warm.stats.n_compiles == 0
    # the legacy plan's explain() reads as the reference's
    jq, tq = greedy[0].prepare(text), greedy[1].prepare(text)
    assert tq.explain() == jq.explain()
    assert "optimizer disabled: legacy greedy order" in tq.explain()


@pytest.mark.parametrize("name", list(QUERIES))
def test_legacy_plan_matches_reference(legacy_engines, name):
    """Same greedy scan order, every backend "mr", filters at the top,
    no pruning, estimates and trace, and the same PlanShape."""
    js, te, _ = legacy_engines
    je = JEngine(js, optimize=False)
    text = QUERIES[name]
    jp = je._build_program(j_parse(text))
    tp = te._build_program(t_parse(text))
    assert [(p.s, p.p, p.o) for p in tp.patterns] == [
        (p.s, p.p, p.o) for p in jp.patterns
    ]
    assert tp.plan.join_backends == jp.plan.join_backends
    assert set(tp.plan.join_backends) <= {"mr"}
    assert tp.plan.join_ests == jp.plan.join_ests
    assert tp.plan.trace == jp.plan.trace
    assert tp.plan.prune is False and jp.plan.prune is False
    assert all(stage == ("top",) for stage, _ in tp.plan.filters)
    _, j_shape, _ = je._canonicalize(jp)
    _, t_shape, _ = te._canonicalize(tp)
    assert t_plan_ir.shape_to_jsonable(t_shape) == (
        j_plan_ir.shape_to_jsonable(j_shape)
    )


@pytest.mark.parametrize("compiled", [True, False])
def test_legacy_filter_at_top_matches_reference(compiled):
    """test_optimizer.py:146-157: the pushed-down filter shrinks the join
    bucket below the legacy plan's, which filters at the top."""
    js = student_store()
    text = ("PREFIX ub: <http://swat.cse.lehigh.edu/onto/univ-bench.owl#>\n"
            "SELECT ?x ?a ?n WHERE { ?x ub:age ?a . "
            "?x ub:name ?n . FILTER (?a >= 32) }")
    _, rl = run_pair(engine_pair(js, optimize=False, compiled=compiled), text)
    _, ro = run_pair(engine_pair(js, compiled=compiled), text)
    assert rows_as_sets(rl.rows) == rows_as_sets(ro.rows)
    assert len(ro.rows) == 1
    assert ro.stats.peak_join_bucket < rl.stats.peak_join_bucket


@pytest.mark.parametrize("compiled", [True, False])
def test_legacy_order_ignores_filter_selectivity(compiled):
    """test_optimizer.py:696: the selectivity-aware order's bucket is
    smaller than the legacy order's, in both packages alike."""
    js = _filter_order_store()
    text = ("SELECT ?x ?y ?z ?w WHERE { ?x <p1> ?y . ?y <p2> ?z . "
            "?z <p3> ?w . FILTER (?x = <x3>) }")
    _, leg = run_pair(engine_pair(js, optimize=False, compiled=compiled),
                      text)
    _, opt = run_pair(engine_pair(js, compiled=compiled), text)
    assert rows_as_sets(opt.rows) == rows_as_sets(leg.rows)
    assert opt.stats.peak_join_bucket < leg.stats.peak_join_bucket


@pytest.mark.parametrize("seed", [0, 3, 5])
@pytest.mark.parametrize("shape", ["bgp", "filter", "optional", "union"])
def test_unoptimized_eager_sweep_matches_reference(seed, shape):
    """test_optimizer.py:474-479's unoptimized eager engine: the port's
    rows and stats are the reference's, and the oracle's."""
    js = _mini_store(seed)
    text = _query_text(shape, p1=seed % 3, p2=(seed + 1) % 3,
                       cmp_op="<" if seed % 2 else ">=", cut=18 + seed)
    _, b = run_pair(engine_pair(js, compiled=False, optimize=False), text)
    assert rows_as_sets(b.rows) == rows_as_sets(
        reference_rows(js, j_parse(text))
    )


# ------------------------------------------ double-on-overflow sizing


def random_triples():
    """test_engine.py:62-73's store: 120 random triples over 12 entities
    and 3 predicates (numpy seed 7)."""
    rng = np.random.default_rng(7)
    ents = [f"<e{i}>" for i in range(12)]
    preds = [f"<p{i}>" for i in range(3)]
    return list({
        (ents[rng.integers(12)], preds[rng.integers(3)],
         ents[rng.integers(12)])
        for _ in range(120)
    })


RANDOM_BGPS = [
    [("?x", "<p0>", "?y"), ("?y", "<p1>", "?z")],
    [("?x", "<p0>", "?y"), ("?x", "<p1>", "?z")],
    [("?x", "?p", "?y"), ("?y", "<p2>", "?z")],
    [("?x", "<p0>", "?y"), ("?y", "<p1>", "?z"), ("?z", "<p2>", "?w")],
]


@pytest.mark.parametrize("compiled", [True, False])
@pytest.mark.parametrize("exact", [True, False])
def test_exact_count_pass_matches_reference(exact, compiled):
    """test_engine.py:62-73 in both packages: the same result arrays and
    ExecStats, whether joins are sized by a count pass or by doubling."""
    triples = random_triples()
    je = JEngine(j_store(triples), exact_count_pass=exact, compiled=compiled)
    te = TEngine(t_store(triples), device="cpu", exact_count_pass=exact,
                 compiled=compiled)
    retries = 0
    for bgp in RANDOM_BGPS:
        a, sa = je.execute(JQuery([], False, [JPattern(*p) for p in bgp]))
        b, sb = te.execute(TQuery([], False, [TPattern(*p) for p in bgp]))
        assert b.schema == a.schema
        np.testing.assert_array_equal(b.cols.numpy(), np.asarray(a.cols))
        np.testing.assert_array_equal(b.valid.numpy(), np.asarray(a.valid))
        assert stats_of(sb) == stats_of(sa)
        assert (sb.n_count_passes > 0) == exact
        retries += sb.n_retries
    assert (retries > 0) == (not exact)


def hub_triples(n: int = 20):
    """n subjects into one hub, n objects out of it: the two-pattern
    chain joins n * n rows from two n-row scans."""
    return ([(f"<s{i}>", "<p>", "<hub>") for i in range(n)]
            + [("<hub>", "<q>", f"<o{i}>") for i in range(n)])


HUB_QUERY = "SELECT ?x ?z WHERE { ?x <p> ?y . ?y <q> ?z . }"


@pytest.mark.parametrize("compiled", [True, False])
def test_double_on_overflow_retries_match_reference(compiled):
    """400 rows from two 32-slot scans: the join starts at 32 and doubles
    to 512, four retries, in both packages; the count pass takes none."""
    js = j_store(hub_triples())
    a, b = run_pair(engine_pair(js, exact_count_pass=False,
                                compiled=compiled), HUB_QUERY)
    assert len(b.rows) == 400
    assert b.stats.n_retries == 4 and b.stats.peak_join_bucket == 512
    _, exact = run_pair(engine_pair(js, compiled=compiled), HUB_QUERY)
    assert exact.stats.n_retries == 0 and exact.rows == b.rows


@pytest.mark.parametrize("compiled", [True, False])
def test_double_on_overflow_raises_past_max_capacity(compiled):
    """Doubling past max_capacity raises MemoryError in both packages."""
    js = j_store(hub_triples())
    je, te = engine_pair(js, exact_count_pass=False, compiled=compiled,
                         max_capacity=64)
    with pytest.raises(MemoryError):
        je.prepare(HUB_QUERY).run()
    with pytest.raises(MemoryError):
        te.prepare(HUB_QUERY).run()


# ------------------------------------------------- the stacking knobs


def warm_batch(eng, copies: int = 4):
    ps = [eng.prepare(t) for t in PAD_QUERIES for _ in range(copies)]
    for p in ps:
        p.run()
    return ps


def stacked_run(eng):
    """Warm every member shape, then one run_batch: its stacked
    dispatches, groups and rows."""
    ps = warm_batch(eng)
    d0 = eng.stacked_dispatches
    res = eng.run_batch(ps)
    groups = [(g.n_queries, g.widths, g.padded, g.n_shapes)
              for g in eng.last_batch]
    return (eng.stacked_dispatches - d0, groups, eng.padded_groups,
            eng.pad_rejects, [r.rows for r in res])


@pytest.mark.parametrize("kw", [
    {}, {"pad_stacking": False}, {"pad_waste_limit": 0.0},
], ids=["padded", "pad_stacking_off", "waste_limit_0"])
def test_pad_stacking_knobs_match_reference(kw):
    """test_serving_pipeline.py:336-366: padded stacking merges the two
    near-miss shapes into fewer dispatches; with it off, or with no
    waste allowed, each shape is its own dispatch. Both packages give the
    same dispatches, groups, counters and rows."""
    je, te = engine_pair(padding_store(), **kw)
    want, got = stacked_run(je), stacked_run(te)
    assert got == want
    dispatches, groups, padded, rejects, _ = got
    if kw:
        assert dispatches == 2 and padded == 0
        assert not any(g[2] for g in groups)
        assert rejects == (1 if "pad_waste_limit" in kw else 0)
    else:
        assert dispatches == 1 and padded == 1 and groups[0][3] == 2


def test_sharded_engine_takes_pad_stacking_off():
    ts = t_store([("<a>", "<p>", "<b>")])
    eng = TShardedEngine(shard_store(ts, 2), device="cpu", pad_stacking=True)
    assert eng.pad_stacking is False
    assert TEngine(ts, device="cpu", pad_stacking=False).pad_stacking is False


def test_stacked_cache_entries_bound_the_cache():
    """TripleStore(stacked_cache_entries=2) keeps at most two stacked
    gathers, evicting as the reference's store does: three batches of one
    shape, each over four other subjects, stack three scan sets."""
    batches = [
        [f"SELECT ?z WHERE {{ <s{k}> <p> ?y . ?y <q> ?z . }}"
         for k in range(b, b + 4)]
        for b in (0, 4, 8)
    ]
    js = chain_store()
    jsmall = JStore(js.triples, js.dictionary, stacked_cache_entries=2)
    ts = port_store(js)
    tsmall = TripleStore(ts.triples, ts.dictionary, stacked_cache_entries=2)
    je, te = JEngine(jsmall), TEngine(tsmall, device="cpu")
    stats = {}
    for name, eng in (("ref", je), ("port", te)):
        rows = []
        for texts in batches:
            for t in texts:
                eng.prepare(t).run()
            rows.append([r.rows for r in eng.run_batch(
                [eng.prepare(t) for t in texts])])
        stats[name] = (eng.store.scan_cache_stats(), rows)
    (j_st, j_rows), (t_st, t_rows) = stats["ref"], stats["port"]
    assert t_rows == j_rows
    assert t_st["stacked_entries"] == j_st["stacked_entries"] == 2


# ---------------------------------- the sharded engine on the legacy plan

SHARDED_LEGACY = ("Q1", "Q2", "Q4", "Q9", "F1", "O1", "U1", "J1", "J2")


@pytest.fixture(scope="module")
def legacy_engines():
    js = j_lubm.generate(scale=1, join_shapes=True, skew_shapes=True)
    ts = port_store(js)
    single = TEngine(ts, device="cpu", optimize=False)
    sharded = TShardedEngine(shard_store(port_store(js), 4), device="cpu",
                             optimize=False)
    return js, single, sharded


@pytest.mark.parametrize("name", SHARDED_LEGACY)
def test_sharded_legacy_plan_matches_single_device_and_oracle(
    legacy_engines, name
):
    """optimize=False on 4 shards: rows equal the single-device port's on
    the same legacy plan and the oracle's, as multisets; warm is one
    dispatch and no compile."""
    js, single, sharded = legacy_engines
    text = QUERIES[name]
    want = rows_as_sets(single.query(text))
    assert want == rows_as_sets(reference_rows(js, j_parse(text)))
    pq = sharded.prepare(text)
    assert set(pq._program.plan.join_backends) <= {"mr"}
    assert pq._program.plan.prune is False
    assert rows_as_sets(pq.run().rows) == want
    warm = pq.run()
    assert rows_as_sets(warm.rows) == want
    assert warm.stats.n_dispatches == 1 and warm.stats.n_compiles == 0


@pytest.mark.parametrize("name", ["Q1", "Q9", "S1", "J1"])
def test_sharded_double_on_overflow_matches_oracle(legacy_engines, name):
    """exact_count_pass=False on 4 shards: the calibration run takes no
    count pass (S1's joins retry), and the rows are the single-device
    port's (held to the oracle above)."""
    _, single, legacy = legacy_engines
    sharded = TShardedEngine(legacy.store, device="cpu",
                             exact_count_pass=False)
    text = QUERIES[name]
    cold = sharded.prepare(text).run()
    assert cold.stats.n_count_passes == 0
    assert (cold.stats.n_retries > 0) == (name == "S1")
    assert rows_as_sets(cold.rows) == rows_as_sets(single.query(text))
