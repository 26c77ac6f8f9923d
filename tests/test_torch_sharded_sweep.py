"""The port's ShardedQueryEngine (device="cpu") against the NumPy oracle and
the reference's single-device QueryEngine on mini stores: the reference's
seeds x {bgp, filter, optional, union} sweep, a broadcast join, stacked
FILTER-constant batches and the write path (inserts, deletes,
compaction), at 1, 2, 4 and 8 shards and on a 2 x 2 mesh."""
import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch  # noqa: F401

from repro.sparql.baseline import reference_rows
from repro.sparql.engine import QueryEngine as JEngine
from repro.sparql.parser import parse as j_parse
from repro.sparql.store import store_from_string_triples as j_store
from repro_torch.sparql.sharded_store import sharded_store_from_string_triples

from test_torch_sharded_engine import CONFIGS, engine_over, rows_key

SEEDS = (0, 3, 5)
SHAPES = ("bgp", "filter", "optional", "union")


def mini_triples(seed: int):
    """The mini random store of the reference's sharded property test."""
    rng = np.random.default_rng(seed)
    ents = [f"<e{i}>" for i in range(6)]
    triples = set()
    for _ in range(40):
        triples.add((ents[rng.integers(6)], f"<p{rng.integers(3)}>",
                     ents[rng.integers(6)]))
    for i in range(6):
        triples.add((ents[i], "<age>", str(15 + 3 * i)))
    return sorted(triples)


def query_text(shape, p1, p2, cmp_op, cut):
    base = f"?x <p{p1}> ?y"
    if shape == "bgp":
        return f"SELECT ?x ?y ?z WHERE {{ {base} . ?y <p{p2}> ?z . }}"
    if shape == "filter":
        return (f"SELECT ?x ?y ?a WHERE {{ {base} . ?x <age> ?a . "
                f"FILTER (?a {cmp_op} {cut} || ?x = <e1>) }}")
    if shape == "optional":
        return (f"SELECT ?x ?y ?z WHERE {{ {base} . "
                f"OPTIONAL {{ ?x <p{p2}> ?z }} }}")
    return (f"SELECT ?x ?v WHERE {{ {{ ?x <p{p1}> ?v }} UNION "
            f"{{ ?x <p{p2}> ?v }} }}")


def sweep_text(seed, shape):
    return query_text(shape, seed % 3, (seed + 1) % 3,
                      "<" if seed % 2 else ">=", 18 + seed)


@pytest.fixture(scope="module")
def sweep_want():
    """(seed, shape) -> (single-device rows, oracle rows), on first use."""
    return {}


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_sweep_equals_single_device_and_oracle(sweep_want, seed, shape,
                                               config):
    triples = mini_triples(seed)
    text = sweep_text(seed, shape)
    if (seed, shape) not in sweep_want:
        js = j_store(triples)
        sweep_want[seed, shape] = (
            rows_key(JEngine(js).query(text)),
            rows_key(reference_rows(js, j_parse(text))),
        )
    single, oracle = sweep_want[seed, shape]
    assert single == oracle
    n, _ = CONFIGS[config]
    store = sharded_store_from_string_triples(triples, n)
    assert rows_key(engine_over(store, config).query(text)) == oracle


@pytest.mark.parametrize("config", ["2", "4", "2x2", "8"])
def test_broadcast_join(config):
    """Both join inputs misaligned on an object-object key and a small
    right side: it is replicated (one all_gather) instead of shuffling
    both sides, and the rows still equal the oracle's."""
    triples = mini_triples(0)
    text = "SELECT ?x ?y ?z WHERE { ?x <p0> ?y . ?z <p1> ?y . }"
    n, _ = CONFIGS[config]
    eng = engine_over(sharded_store_from_string_triples(triples, n),
                            config)
    want = rows_key(reference_rows(j_store(triples), j_parse(text)))
    pq = eng.prepare(text)
    assert rows_key(pq.run().rows) == want
    warm = pq.run().stats
    assert warm.n_broadcast_joins == 1 and warm.n_shuffles_emitted == 0


@pytest.mark.parametrize("config", ["1", "4", "2x2"])
def test_cross_join(config):
    """A disconnected BGP: the right side is replicated on every shard
    (all_gather) and crossed with each shard's left slice."""
    triples = mini_triples(5)
    text = "SELECT ?x ?y ?a WHERE { ?x <p0> ?y . ?a <age> 21 . }"
    n, _ = CONFIGS[config]
    eng = engine_over(sharded_store_from_string_triples(triples, n), config)
    want = rows_key(reference_rows(j_store(triples), j_parse(text)))
    assert want
    pq = eng.prepare(text)
    assert rows_key(pq.run().rows) == want
    warm = pq.run()
    assert rows_key(warm.rows) == want
    assert warm.stats.n_dispatches == 1 and warm.stats.n_compiles == 0


@pytest.mark.parametrize("config", ["4", "2x2"])
def test_stacked_filter_batch(config):
    """Warm same-shape queries with other FILTER constants ride ONE
    stacked (lanes x shards) dispatch."""
    triples = mini_triples(3)
    n, _ = CONFIGS[config]
    eng = engine_over(sharded_store_from_string_triples(triples, n),
                            config)
    texts = [query_text("filter", 0, 1, ">=", cut) for cut in (16, 19, 25)]
    eng.query(texts[0])
    out = eng.run_batch([eng.prepare(t) for t in texts])
    js = j_store(triples)
    for t, rs in zip(texts, out):
        assert rows_key(rs.rows) == rows_key(reference_rows(js, j_parse(t)))
    (group,) = eng.last_batch
    assert not group.fallback
    assert group.widths == (4,) and group.n_dispatches == 1


def apply_script(store):
    """The reference's update script (tests/test_updates.py): inserts
    reuse existing entities, deletes hit rows every seed generates."""
    ins1 = [("<e0>", "<p0>", "<e5>"), ("<e5>", "<p1>", "<e0>"),
            ("<e4>", "<p2>", "<e4>")]
    dels = list(mini_triples(3)[:6])
    ins2 = [("<e2>", "<p0>", "<e2>"), ("<e1>", "<p2>", "<e5>")]
    store.insert_triples(ins1)
    store.delete_triples(dels)
    store.insert_triples(ins2)


def decoded(store):
    d = store.dictionary
    return sorted({tuple(d.decode(int(t)) for t in row)
                   for row in np.asarray(store.triples)})


@pytest.mark.parametrize("config", ["1", "4", "2x2"])
def test_updates_differential_sharded(config):
    """Inserts, deletes and compaction on the sharded store: the warm
    engine's rows equal the oracle's and a fresh single-device reference
    engine's over the same triples."""
    triples = mini_triples(5)
    n, _ = CONFIGS[config]
    store = sharded_store_from_string_triples(triples, n)
    eng = engine_over(store, config)
    texts = [query_text("bgp", 0, 1, ">=", 21),
             query_text("optional", 0, 1, ">=", 21)]
    for t in texts:
        eng.query(t)  # warm pre-update
    js = j_store(triples)
    apply_script(store)
    apply_script(js)

    def check():
        fresh = JEngine(j_store(decoded(store)), compiled=False)
        assert decoded(store) == decoded(js)
        for t in texts:
            want = rows_key(reference_rows(js, j_parse(t)))
            assert rows_key(eng.query(t)) == want, t
            assert rows_key(fresh.query(t)) == want, t

    check()
    ws = store.write_stats()
    assert ws["n_shards"] == n and ws["tail_rows"] > 0
    assert ws["tombstones"] > 0
    store.compact()
    js.compact()
    check()
    assert store.write_stats()["compactions"] == 1
