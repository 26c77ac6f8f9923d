"""The port's ShardedQueryEngine (device="cpu") against the reference's
single-device QueryEngine, on identical data, at 1, 2, 4 and 8 shards and
on a 2 x 2 mesh: every LUBM query shape, warm cost, the shuffle and join
retry, stacked batches, the warmup file, explain and the constructor's
rejections. test_torch_sharded_oracle.py holds the same engines to the
NumPy oracle.

The reference's own ShardedQueryEngine does not run on this JAX version,
so the port is held to what the reference's acceptance program holds it
to (tests/distributed/sharded_query_prog.py): the single-device engine's
rows and the oracle's, as multisets."""
import json

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import pytest
import torch  # noqa: F401

from repro.sparql.baseline import reference_rows
from repro.sparql.engine import QueryEngine as JEngine
from repro.sparql.parser import parse as j_parse
from repro_torch.core import dist_executor as t_dx
from repro_torch.core import distributed as t_dist
from repro_torch.sparql import lubm as t_lubm
from repro_torch.sparql.engine import ExecStats
from repro_torch.sparql.engine import QueryEngine as TEngine
from repro_torch.sparql.engine import ShardedQueryEngine
from repro_torch.sparql.sharded_store import shard_store

from test_torch_engine_default import QUERIES, store_pair

# shard counts and meshes: name -> (n_shards, mesh axis sizes and names)
CONFIGS = {
    "1": (1, None),
    "2": (2, None),
    "4": (4, None),
    "8": (8, None),
    "2x2": (4, ((2, 2), ("pod", "data"))),
}


def rows_key(rows):
    return sorted(tuple(sorted(r.items())) for r in rows)


def engine_over(sharded, config: str, **kw) -> ShardedQueryEngine:
    """The sharded engine over a sharded store, on configuration
    `config`'s mesh."""
    _, mesh = CONFIGS[config]
    return ShardedQueryEngine(
        sharded, device="cpu",
        mesh=t_dist.make_mesh(*mesh) if mesh else None, **kw,
    )


def sharded_engine(store, config: str, **kw) -> ShardedQueryEngine:
    return engine_over(shard_store(store, CONFIGS[config][0]), config, **kw)


def check_rows(got, want, want_all, text):
    """`want` the single-device rows; `want_all` those of the query
    without its LIMIT: any right-sized subset is a correct slice."""
    if "LIMIT" in text:
        assert len(got) == len(want)
        assert set(got) <= set(want_all)
    else:
        assert got == want


@pytest.fixture(scope="module")
def world():
    """The stores, the reference single-device engine's rows per query
    (and of the query without its LIMIT), and one sharded engine per
    configuration."""
    js, ts = store_pair()
    je = JEngine(js)
    want = {}
    for name, text in QUERIES.items():
        unlimited = text.split("LIMIT")[0]
        want[name] = (rows_key(je.query(text)),
                      rows_key(je.query(unlimited)))
    engines = {c: sharded_engine(ts, c) for c in CONFIGS}
    return js, ts, want, engines


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("name", list(QUERIES))
def test_rows_equal_single_device(world, name, config):
    _, _, want, engines = world
    text = QUERIES[name]
    pq = engines[config].prepare(text)
    cold = pq.run()
    check_rows(rows_key(cold.rows), *want[name], text)
    warm = pq.run()
    check_rows(rows_key(warm.rows), *want[name], text)
    assert warm.stats.n_dispatches == 1
    assert warm.stats.n_compiles == 0
    assert warm.stats.cache_hits == 1
    assert warm.stats.n_retries == 0


def test_per_shard_buckets_shrink(world):
    """Per-shard join buckets never exceed the single-device bucket and
    are smaller on the join-heavy queries."""
    _, ts, _, engines = world
    single = TEngine(ts, device="cpu")
    wins = 0
    for name in ("Q2", "Q9", "J1", "J2"):
        a = single.prepare(QUERIES[name])
        a.run()
        b = engines["4"].prepare(QUERIES[name])
        b.run()
        sh, si = b.run().stats.peak_join_bucket, a.run().stats.peak_join_bucket
        assert sh <= si, name
        wins += sh < si
    assert wins > 0


def test_shuffle_elision_and_broadcast(world):
    """A subject star emits no shuffle (both scans born aligned); a chain
    emits one per join; a small doubly-misaligned side broadcasts."""
    _, ts, _, engines = world
    eng = engines["4"]
    p = t_lubm.PREFIX
    star = p + "SELECT ?s ?a WHERE { ?s a ub:GraduateStudent . ?s ub:advisor ?a . }"
    chain = p + "SELECT ?s ?n WHERE { ?s ub:advisor ?p . ?p ub:name ?n . }"
    for text, emitted, elided in ((star, 0, 2), (chain, 1, 1)):
        pq = eng.prepare(text)
        pq.run()
        warm = pq.run().stats
        assert (warm.n_shuffles_emitted, warm.n_shuffles_elided) == (
            emitted, elided)
    one = engines["1"].prepare(chain)
    one.run()
    assert one.run().stats.n_shuffles_emitted == 0


def test_forced_small_caps_retry_to_the_same_rows(world):
    """A program compiled at the smallest join AND shuffle buckets
    overflows on some shard; the retry grows both from the worst shard's
    exact numbers and returns the same rows."""
    _, ts, want, _ = world
    for config in ("4", "2x2"):
        eng = sharded_engine(ts, config)
        grown = 0
        for name in ("Q2", "Q9", "U1"):
            pq = eng.prepare(QUERIES[name])
            pq.run()
            shape = eng._batch_context(pq._program).shape
            entry = eng.plan_cache.get(shape)
            n_slots = len(entry.compiled.shuffle_caps)
            eng._compile_entry(
                shape, (8,) * len(entry.join_caps), ExecStats(),
                shuffle_caps=(8,) * n_slots,
            )
            rs = pq.run()
            assert rs.stats.n_retries >= 1
            assert rows_key(rs.rows) == want[name][0]
            assert any(rs.stats.join_overflows)
            grown += any(
                c > 8 for c in eng.plan_cache.get(shape).compiled.shuffle_caps
            )
            again = pq.run()
            assert again.stats.n_retries == 0 and again.stats.n_compiles == 0
        assert grown  # a shuffle bucket overflowed and grew too
        # a regrow past max_capacity gives up
        eng._compile_entry(
            shape, (8,) * len(entry.join_caps), ExecStats(),
            shuffle_caps=(8,) * n_slots,
        )
        eng.max_capacity = 16
        with pytest.raises(MemoryError):
            pq.run()


@pytest.mark.parametrize("config", ["4", "2x2"])
def test_run_batch_stacks_same_shape_queries(world, config):
    js, ts, want, _ = world
    eng = sharded_engine(ts, config)
    text = QUERIES["Q2"]
    eng.query(text)  # warm the shape
    out = eng.run_batch([eng.prepare(text) for _ in range(3)])
    assert all(rows_key(r.rows) == want["Q2"][0] for r in out)
    group = eng.last_batch[0]
    assert not group.fallback
    assert group.n_dispatches == 1  # one dispatch for the whole chunk
    assert group.widths == (4,)
    assert all(r.stats.join_worst for r in out)
    # FILTER-constant variants: one shape, per-lane constants
    texts = [QUERIES["F1"].replace("prof_0_0_0", v)
             for v in ("prof_0_0_0", "prof_0_1_0", "nobody")]
    eng.query(texts[0])
    out = eng.run_batch([eng.prepare(t) for t in texts])
    assert eng.last_batch[0].n_dispatches == 1
    for t, r in zip(texts, out):
        assert rows_key(r.rows) == rows_key(reference_rows(js, j_parse(t)))
    assert len({len(r.rows) for r in out}) > 1  # the constants differ


def test_run_batch_mixed_shapes_isolated_per_group(world):
    _, _, want, engines = world
    eng = engines["2"]
    out = eng.run_batch([eng.prepare(QUERIES["Q1"]),
                         eng.prepare(QUERIES["Q4"])])
    assert [rows_key(r.rows) for r in out] == [want["Q1"][0], want["Q4"][0]]
    assert len(eng.last_batch) == 2  # one group per plan shape


def test_save_cache_roundtrips_shuffle_caps(world, tmp_path):
    _, ts, want, _ = world
    eng = sharded_engine(ts, "2x2")
    for name in ("Q7", "Q9"):
        eng.prepare(QUERIES[name]).run()
    path = tmp_path / "warm.json"
    assert eng.save_cache(str(path)) >= 2
    data = json.loads(path.read_text())
    assert all(len(e["shuffle_caps"]) > 0 for e in data["entries"])
    # restart: compiles straight at the persisted caps — no calibration
    eng2 = sharded_engine(ts, "2x2", warmup_path=str(path))
    for name in ("Q7", "Q9"):
        rs = eng2.prepare(QUERIES[name]).run()
        assert rs.stats.n_count_passes == 0
        assert rs.stats.n_retries == 0
        assert rows_key(rs.rows) == want[name][0]
    saved = {json.dumps(e["shape"]): e["shuffle_caps"]
             for e in data["entries"]}
    for e in eng2.plan_cache.entries():
        key = json.dumps(eng2._entry_jsonable(e)["shape"])
        assert list(e.compiled.shuffle_caps) == saved[key]


def test_explain_shows_shard_buckets_and_data_movement(world):
    _, _, _, engines = world
    eng = engines["4"]
    pq = eng.prepare(QUERIES["Q2"])
    before = pq.explain()
    assert "sharded: 4 shard(s)" in before
    assert "per-shard rows=" in before and "shuffle[0]" in before
    pq.run()
    out = pq.explain(analyze=True)
    assert "shuffle buckets=" in out
    assert "EXPLAIN ANALYZE (last run):" in out
    assert "worst_shard_rows=" in out
    assert "data movement:" in out
    st = pq.last_stats
    assert len(st.join_worst) == len(st.join_totals) >= 1
    assert all(w <= t for w, t in zip(st.join_worst, st.join_totals))
    assert len(st.shuffle_loads) == len(
        pq.engine.plan_cache.get(
            eng._batch_context(pq._program).shape).compiled.shuffle_caps)


def test_constructor_rejections(world):
    _, ts, _, _ = world
    with pytest.raises(TypeError):
        ShardedQueryEngine(ts, device="cpu")
    with pytest.raises(ValueError):
        ShardedQueryEngine(shard_store(ts, 3), device="cpu",
                           mesh=t_dist.make_mesh((2,), ("shards",)))
    with pytest.raises(ValueError):
        ShardedQueryEngine(shard_store(ts, 1), device="cpu", compiled=False)
    eng = ShardedQueryEngine(shard_store(ts, 3), device="cpu")
    assert eng.mesh.axis_names == ("shards",) and eng.n_shards == 3
    assert eng.pad_stacking is False


def test_programs_are_sharded_plans(world):
    _, _, _, engines = world
    eng = engines["2x2"]
    eng.query(QUERIES["Q9"])
    for e in eng.plan_cache.entries():
        assert isinstance(e.compiled, t_dx.CompiledShardedPlan)
        assert e.compiled.n_shards == 4
