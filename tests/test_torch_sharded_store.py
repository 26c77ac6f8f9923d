"""The port's sharded store and shuffle primitives against the reference's:
the subject hash, FNV-1a and the shuffle buckets bit for bit, the per-shard
partitions, flat scans, merged statistics and the routed write path, on
identical data."""
import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as j_dist
from repro.core.planner import TriplePattern as JTP
from repro.sparql import lubm as j_lubm
from repro.sparql import sharded_store as j_ss
from repro.sparql.store import StoreStatistics as JStats
from repro_torch.core import distributed as t_dist
from repro_torch.core.planner import TriplePattern as TTP
from repro_torch.sparql import sharded_store as t_ss
from repro_torch.sparql.store import StoreStatistics as TStats
from repro_torch.sparql.store import TripleStore

INT32_MAX = 2**31 - 1
SENTINELS = (INT32_MAX, INT32_MAX - 1, -(2**31), -1, 0)


def _ids(seed: int, n: int) -> np.ndarray:
    """Seeded int32 ids over the whole range, with the sentinel keys and
    negatives mixed in."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-(2**31), 2**31, size=max(n, 10), dtype=np.int64)
    ids[: len(SENTINELS)] = SENTINELS
    ids[len(SENTINELS): 2 * len(SENTINELS)] = rng.integers(-50, 50, 5)
    return rng.permutation(ids)[:n].astype(np.int32)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8, 7919])
@pytest.mark.parametrize("seed", [0, 1])
def test_subject_shard_equals_reference(seed, n_shards):
    ids = _ids(seed, 4096)
    got = t_ss.subject_shard(ids, n_shards)
    np.testing.assert_array_equal(got, j_ss.subject_shard(ids, n_shards))


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_hash_keys_equals_reference(seed, k):
    cols = _ids(seed, 3000 * k).reshape(3000, k)
    want = np.asarray(j_dist.hash_keys(jnp.asarray(cols))).astype(np.int64)
    got = t_dist.hash_keys(torch.from_numpy(cols))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_shards", [1, 4, 8])
def test_device_hash_routes_like_the_host_subject_hash(n_shards):
    """A subject scan is "already partitioned" only if the store's host
    hash and the shuffle's device hash route every id identically."""
    ids = _ids(2, 5000)
    dest = t_dist.hash_keys(torch.from_numpy(ids)[:, None]) % n_shards
    np.testing.assert_array_equal(
        dest.numpy(), t_ss.subject_shard(ids, n_shards)
    )


def _bucketize_both(seed, n, c, parts, cap, p_valid=0.8):
    rng = np.random.default_rng(seed)
    cols = _ids(seed, n * c).reshape(n, c)
    valid = rng.random(n) < p_valid
    part = rng.integers(0, parts, n).astype(np.int32)
    want = j_dist.bucketize(
        jnp.asarray(cols), jnp.asarray(valid), jnp.asarray(part), parts, cap
    )
    got = t_dist.bucketize(
        torch.from_numpy(cols), torch.from_numpy(valid),
        torch.from_numpy(part), parts, cap,
    )
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize(
    "n,c,parts,cap",
    [(1, 1, 1, 8), (100, 2, 4, 64), (1000, 3, 8, 256), (777, 2, 3, 512),
     (64, 1, 2, 8)],
)
@pytest.mark.parametrize("seed", [0, 5])
def test_bucketize_equals_reference(seed, n, c, parts, cap):
    """Buckets, validity, overflow flag and the exact max load, including
    caps that overflow (the last shapes) and ones that do not."""
    want, got = _bucketize_both(seed, n, c, parts, cap)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_bucketize_overflow_reports_the_exact_load():
    want, got = _bucketize_both(3, 4000, 2, 4, 64, p_valid=0.9)
    assert bool(want[2]) and bool(got[2])  # the cap overflows
    assert int(got[3]) == int(want[3]) > 64
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_bucketize_batched_equals_per_shard_calls():
    rng = np.random.default_rng(7)
    cols = torch.from_numpy(_ids(7, 3 * 200 * 2).reshape(3, 200, 2))
    valid = torch.from_numpy(rng.random((3, 200)) < 0.7)
    part = torch.from_numpy(rng.integers(0, 4, (3, 200)).astype(np.int32))
    batched = t_dist.bucketize(cols, valid, part, 4, 32)
    for b in range(3):
        single = t_dist.bucketize(cols[b], valid[b], part[b], 4, 32)
        for x, y in zip(batched, single):
            assert torch.equal(x[b], y)


# -- the store ----------------------------------------------------------------


@pytest.fixture(scope="module")
def lubm_pair():
    js = j_lubm.generate(scale=1, seed=0, join_shapes=True, skew_shapes=True)
    terms = [js.dictionary.decode(i) for i in range(len(js.dictionary))]
    return js, TripleStore.from_arrays(js.triples, terms)


PATTERNS = [
    ("?s", j_lubm.RDF_TYPE, f"<{j_lubm.UB}GraduateStudent>"),
    ("?s", f"<{j_lubm.UB}memberOf>", "?d"),
    ("?x", "?p", "?x"),
    ("?s", f"<{j_lubm.UB}advisor>", "?a"),
    ("?s", "?p", "?o"),
]


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_partitions_and_flat_scans_equal_reference(lubm_pair, n_shards):
    js, ts = lubm_pair
    jss, tss = j_ss.shard_store(js, n_shards), t_ss.shard_store(ts, n_shards)
    assert tss.shard_sizes() == jss.shard_sizes()
    assert sum(tss.shard_sizes()) == len(ts)
    for jsh, tsh in zip(jss.shards, tss.shards):
        np.testing.assert_array_equal(tsh.triples, jsh.triples)
    for spo in PATTERNS:
        jtp, ttp = JTP(*spo), TTP(*spo)
        want = jss.match_pattern_device(jtp)
        got = tss.match_pattern_device(ttp, "cpu")
        assert got.schema == want.schema
        np.testing.assert_array_equal(got.cols.numpy(), np.asarray(want.cols))
        np.testing.assert_array_equal(
            got.valid.numpy(), np.asarray(want.valid)
        )
        assert tss.scan_capacity(ttp) == jss.scan_capacity(jtp)
        assert tss.pattern_scan_info(ttp) == jss.pattern_scan_info(jtp)
        assert tss.per_shard_counts(ttp) == jss.per_shard_counts(jtp)
        assert tss.estimate_cardinality(ttp) == jss.estimate_cardinality(jtp)
        assert tss.estimate_cardinality(ttp) == ts.estimate_cardinality(ttp)
    assert tss.scan_cache_stats()["misses"] == len(PATTERNS)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_statistics_merge_equals_reference(lubm_pair, n_shards):
    js, ts = lubm_pair
    jss, tss = j_ss.shard_store(js, n_shards), t_ss.shard_store(ts, n_shards)
    assert tss.statistics.to_jsonable() == jss.statistics.to_jsonable()
    parts = [s.statistics for s in tss.shards]
    merged = TStats.merge(parts)
    want = JStats.merge([s.statistics for s in jss.shards])
    assert merged.to_jsonable() == want.to_jsonable()
    exact = ts.statistics
    assert merged.n_triples == exact.n_triples
    assert merged.n_subjects == exact.n_subjects
    for pid, ps in exact.predicates.items():
        assert merged.predicates[pid].count == ps.count
        assert merged.predicates[pid].n_subjects == ps.n_subjects
        assert merged.predicates[pid].n_objects <= ps.n_objects


def test_stacked_scans_and_cache_versions():
    tss = t_ss.sharded_store_from_string_triples(_mini_triples(1), 4)
    tp = TTP("?x", "<p1>", "?y")
    cols, valid = tss.stacked_scan_device((tp,) * 3, "cpu")
    one = tss.match_pattern_device(tp, "cpu")
    assert cols.shape == (3, *one.cols.shape)
    assert all(torch.equal(cols[k], one.cols) for k in range(3))
    assert all(torch.equal(valid[k], one.valid) for k in range(3))
    again = tss.stacked_scan_device((tp,) * 3, "cpu")
    assert again[0] is cols  # cached at this version
    misses = tss.scan_cache_stats()["misses"]
    tss.insert_triples([("<e9>", "<p1>", "<e0>")])
    fresh, _ = tss.stacked_scan_device((tp,) * 3, "cpu")
    st = tss.scan_cache_stats()
    assert st["evictions"] == 2  # the stacked entry and the flat one
    assert st["misses"] == misses + 2
    assert int(fresh[0].sum()) != int(cols[0].sum())


def _mini_triples(seed: int):
    rng = np.random.default_rng(seed)
    ents = [f"<e{i}>" for i in range(6)]
    triples = set()
    for _ in range(40):
        triples.add((ents[rng.integers(6)], f"<p{rng.integers(3)}>",
                     ents[rng.integers(6)]))
    for i in range(6):
        triples.add((ents[i], "<age>", str(15 + 3 * i)))
    return sorted(triples)


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_writes_route_like_the_reference(n_shards):
    """Inserts route to the owner shard, deletes tombstone there, compact
    folds every shard: shard contents, write stats and the capacity
    floors equal the reference's after each step."""
    triples = _mini_triples(5)
    jss = j_ss.sharded_store_from_string_triples(triples, n_shards)
    tss = t_ss.sharded_store_from_string_triples(triples, n_shards)
    tp = ("?x", "<p1>", "?y")
    ins = [("<e9>", "<p1>", "<e2>"), ("<e1>", "<p1>", "<e7>"),
           ("<e0>", "<p1>", "<e8>")]
    dels = [triples[0], triples[3], ("<nope>", "<p1>", "<e1>")]
    steps = [
        lambda s: s.insert_triples(ins),
        lambda s: s.insert_triples(ins),  # duplicates: set semantics
        lambda s: s.delete_triples(dels),
        lambda s: s.compact(),
    ]
    for step in steps:
        assert step(tss) == step(jss)
        assert tss.write_stats() == jss.write_stats()
        for jsh, tsh in zip(jss.shards, tss.shards):
            np.testing.assert_array_equal(tsh.triples, jsh.triples)
        np.testing.assert_array_equal(tss.triples, jss.triples)
        assert tss.scan_capacity(TTP(*tp)) == jss.scan_capacity(JTP(*tp))
        got = tss.match_pattern_device(TTP(*tp), "cpu")
        want = jss.match_pattern_device(JTP(*tp))
        np.testing.assert_array_equal(got.cols.numpy(), np.asarray(want.cols))
        np.testing.assert_array_equal(
            got.valid.numpy(), np.asarray(want.valid)
        )
        assert tss.statistics.to_jsonable() == jss.statistics.to_jsonable()
