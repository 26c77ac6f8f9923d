"""The port's data generator, store, optimizer, updates and warmup files
against the reference's, on identical data."""
import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import torch  # noqa: F401
import numpy as np
import pytest

from test_torch_engine_default import QUERIES, engine_pair, run_both, store_pair
from repro.core import plan_ir as j_plan_ir
from repro.sparql import lubm as j_lubm
from repro.sparql.engine import QueryEngine as JEngine
from repro.sparql.parser import parse as j_parse
from repro_torch.core import plan_ir as t_plan_ir
from repro_torch.sparql import lubm as t_lubm
from repro_torch.sparql.engine import QueryEngine as TEngine
from repro_torch.sparql.parser import parse as t_parse


@pytest.fixture(scope="module")
def stores():
    return store_pair()


@pytest.mark.parametrize("scale", [1, 2])
def test_lubm_generate_matches_reference(scale):
    js = j_lubm.generate(scale=scale, join_shapes=True, skew_shapes=True)
    ts = t_lubm.generate(scale=scale, join_shapes=True, skew_shapes=True)
    np.testing.assert_array_equal(ts.triples, js.triples)
    assert ts.dictionary._id_to_term == js.dictionary._id_to_term
    assert t_lubm.QUERIES == j_lubm.QUERIES
    assert t_lubm.J_QUERIES == j_lubm.J_QUERIES
    assert t_lubm.S_QUERIES == j_lubm.S_QUERIES


def test_statistics_catalog_matches_reference(stores):
    js, ts = stores
    assert ts.statistics.to_jsonable() == js.statistics.to_jsonable()


@pytest.mark.parametrize("name", list(QUERIES))
def test_optimizer_choices_match_reference(stores, name):
    """Same scan order, join structure, backends and PlanShape."""
    je, te = engine_pair(stores)
    jp = je._build_program(j_parse(QUERIES[name]))
    tp = te._build_program(t_parse(QUERIES[name]))
    assert [(p.s, p.p, p.o) for p in tp.patterns] == [
        (p.s, p.p, p.o) for p in jp.patterns
    ]
    assert tp.cross_flags == jp.cross_flags
    assert tp.plan.join_backends == jp.plan.join_backends
    assert tp.plan.join_ests == jp.plan.join_ests
    assert tp.plan.trace == jp.plan.trace
    _, j_shape, _ = je._canonicalize(jp)
    _, t_shape, _ = te._canonicalize(tp)
    assert t_plan_ir.shape_to_jsonable(t_shape) == j_plan_ir.shape_to_jsonable(
        j_shape
    )


def test_explain_matches_reference(stores):
    je, te = engine_pair(stores)
    for name in ("Q9", "FO1", "S1"):
        jq, tq = je.prepare(QUERIES[name]), te.prepare(QUERIES[name])
        assert tq.explain() == jq.explain()
        jq.run()
        tq.run()
        assert tq.explain() == jq.explain()
        analyze = tq.explain(analyze=True)
        assert "EXPLAIN ANALYZE (last run):" in analyze
        assert "actual_rows=" in analyze


def test_updates_keep_engines_equal():
    pair = engine_pair(store_pair(), join_backend=None)
    names = ("Q1", "Q7", "O1", "U1")
    handles = {n: (pair[0].prepare(QUERIES[n]), pair[1].prepare(QUERIES[n]))
               for n in names}
    for n in names:
        run_both(pair, QUERIES[n])
    update = t_lubm.PREFIX + """
        INSERT DATA {
          <http://example.org/NewStudent> rdf:type ub:GraduateStudent .
          <http://example.org/NewStudent> ub:takesCourse
              <http://example.org/Course0_0_0> .
        } ;
        DELETE DATA {
          <http://example.org/Student0_0_0> rdf:type ub:GraduateStudent .
        }"""
    j_res, t_res = pair[0].update(update), pair[1].update(update)
    assert (t_res.inserted, t_res.deleted) == (2, 1)
    assert (t_res.inserted, t_res.deleted, t_res.n_ops, t_res.version) == (
        j_res.inserted, j_res.deleted, j_res.n_ops, j_res.version)
    np.testing.assert_array_equal(pair[1].store.triples, pair[0].store.triples)
    for n in names:
        jq, tq = handles[n]
        assert tq.refresh() == jq.refresh()
        a, b = jq.run(), tq.run()
        assert b.rows == a.rows
        assert b.stats.store_version == a.stats.store_version
    assert pair[1].stats()["store"] == pair[0].stats()["store"]


def test_warmup_file_loads_across_engines(stores, tmp_path):
    """A warmup file (v3) written by either engine makes the other compile
    straight at the saved join caps, with no calibration run."""
    js, ts = stores
    names = ("Q2", "Q9", "S1", "FO1")
    je, te = engine_pair(stores)
    for n in names:
        run_both((je, te), QUERIES[n])
    for writer, make_reader in (
        (je, lambda p: TEngine(ts, device="cpu", warmup_path=p)),
        (te, lambda p: JEngine(js, warmup_path=p)),
    ):
        path = str(tmp_path / f"warm-{type(writer).__module__}.json")
        assert writer.save_cache(path) == len(writer.plan_cache)
        reader = make_reader(path)
        for n in names:
            rs = reader.prepare(QUERIES[n]).run()
            ref = writer.prepare(QUERIES[n]).run()
            assert rs.rows == ref.rows
            assert rs.stats.n_count_passes == 0
            assert rs.stats.n_compiles == 1
            assert rs.stats.join_caps == ref.stats.join_caps


@pytest.mark.parametrize("name", ["Q9", "O1", "U1", "S1"])
def test_execute_plan_matches_reference(stores, name):
    """The op-by-op interpretation of one physical plan gives the
    reference's arrays, totals and flags, and both name the same join
    node per actuals slot."""
    import jax.numpy as jnp
    import torch

    from repro.core import executor as j_ex
    from repro_torch.core import executor as t_ex

    je, te = engine_pair(stores)
    jq, tq = je.prepare(QUERIES[name]), te.prepare(QUERIES[name])
    jq.run()
    tq.run()
    j_scans, j_shape, _ = je._canonicalize(jq._program)
    t_scans, t_shape, _ = te._canonicalize(tq._program)
    caps = je.plan_cache.get(j_shape).join_caps
    assert te.plan_cache.get(t_shape).join_caps == caps
    j_plan = j_plan_ir.build_plan(j_shape, caps)
    t_plan = t_plan_ir.build_plan(t_shape, caps)
    jp, tp = jq._program, tq._program
    j_out = j_ex.execute_plan(
        j_plan, j_scans, jnp.asarray(jp.consts_i), jnp.asarray(jp.consts_f),
        je.store.numeric_values_device(),
    )
    t_out = t_ex.execute_plan(
        t_plan, t_scans, torch.from_numpy(tp.consts_i),
        torch.from_numpy(tp.consts_f), te.store.numeric_values_device("cpu"),
    )
    np.testing.assert_array_equal(t_out.relation.cols.numpy(),
                                  np.asarray(j_out.relation.cols))
    np.testing.assert_array_equal(t_out.relation.valid.numpy(),
                                  np.asarray(j_out.relation.valid))
    np.testing.assert_array_equal(t_out.totals.numpy(), np.asarray(j_out.totals))
    np.testing.assert_array_equal(t_out.overflows.numpy(),
                                  np.asarray(j_out.overflows))
    assert [type(n).__name__ for n in t_ex.join_slot_nodes(t_plan)] == [
        type(n).__name__ for n in j_ex.join_slot_nodes(j_plan)
    ]


def test_traced_run_records_the_pipeline_phases(stores):
    from repro_torch.obs import Tracer

    _, ts = stores
    tracer = Tracer()
    engine = TEngine(ts, device="cpu", tracer=tracer)
    for _ in range(2):
        trace = tracer.new_trace("query")
        engine.prepare(QUERIES["Q2"], trace=trace).run(trace=trace)
        tracer.finish(trace)
    names = {s.name for s in tracer.recent()[-1].spans}
    assert {"parse", "optimize", "dispatch", "transfer", "decode"} <= names
    assert "mapsq_plan_cache_hits_total 1" in engine.render_prometheus()


def test_overflow_regrow_matches_reference(stores):
    """Two queries of one plan shape that differ in a FILTER constant: the
    first calibrates a tiny join bucket, the second overflows it, grows it
    from the exact total and retries — on both engines alike."""
    text = t_lubm.PREFIX + """SELECT ?s ?a WHERE {
        ?s ub:memberOf ?d .
        ?s ub:advisor ?a .
        FILTER (?d = <http://example.org/%s>)
    }"""
    je, te = engine_pair(stores)
    run_both((je, te), text % "NoSuchDept")
    a, b = run_both((je, te), text % "Dept0_0")
    assert b.stats.n_retries == a.stats.n_retries == 1
    assert b.stats.join_overflows == a.stats.join_overflows == (1,)
    assert len(b.rows) > 8
    _, warm = run_both((je, te), text % "Dept0_1")
    assert (warm.stats.n_dispatches, warm.stats.n_compiles) == (1, 0)
