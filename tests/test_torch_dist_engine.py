"""ShardedQueryEngine with one shard per process (gloo on the CPU), at
LUBM scale 2 over 2 and 4 ranks and a 2 x 2 mesh (scale 1 over 8 ranks:
test_torch_dist_engine8.py).

Rank 0 drives the engine through its public calls (test_torch_dist_ranks.
drive) and the other ranks follow. Held, call for call, to the
one-process ShardedQueryEngine on the same mesh given the same calls:
rank 0's result arrays in order, every run's ExecStats on every rank,
the plan caches, a forced retry, a MemoryError past max_capacity that
every rank meets and goes past, run_batch groups, an update and the
query after it. Rows are held to the reference's single-device
QueryEngine (as multisets; a LIMIT by size and containment) and, on the
queries the pure-Python oracle answers quickly, to `reference_rows`
(test_torch_sharded_oracle.py holds the one-process engine to it on
every query). The reference's own sharded engine fails on this JAX."""
import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch  # noqa: F401

from repro.sparql.baseline import reference_rows
from repro.sparql.engine import QueryEngine as JEngine
from repro.sparql.parser import parse as j_parse
from repro_torch.core import distributed as t_dist
from repro_torch.sparql import lubm as t_lubm
from repro_torch.sparql.engine import ShardedQueryEngine
from repro_torch.sparql.sharded_store import shard_store

from test_torch_dist_ranks import drive, engine_script, run_ranks, save_store
from test_torch_engine_default import QUERIES as BASE_QUERIES
from test_torch_engine_default import store_pair
from test_torch_sharded_engine import check_rows, rows_key

QUERIES = {
    **BASE_QUERIES,
    "D1q": t_lubm.PREFIX + "SELECT DISTINCT ?d WHERE { ?s ub:memberOf ?d . }",
    "L1": t_lubm.PREFIX + "SELECT ?s ?d WHERE { ?s ub:memberOf ?d . } LIMIT 17",
}
NEW = "<http://example.org/NewStudent>"
UPDATE = t_lubm.PREFIX + (
    f"INSERT DATA {{ {NEW} ub:takesCourse <http://example.org/Course0_0_0> "
    f". {NEW} rdf:type ub:GraduateStudent . }}"
)
BATCH = [BASE_QUERIES["F1"].replace("prof_0_0_0", v)
         for v in ("prof_0_0_0", "prof_0_1_0", "prof_1_0_0", "nobody")]
RETRY = ("Q2", "Q9", "U1")


def engine_module_tests(configs: dict, scale: int, oracle: tuple):
    """The fixture and tests of one module: `configs` maps a name to
    (mesh axis sizes, axis names); `oracle` names the queries held to
    reference_rows."""

    @pytest.fixture(scope="module")
    def world(tmp_path_factory):
        js, ts = store_pair(scale)
        tmp = tmp_path_factory.mktemp("engine")
        data = save_store(ts, tmp / "store.npz")
        je = JEngine(js)
        want = {}
        for name, text in QUERIES.items():
            want[name] = (rows_key(je.query(text)),
                          rows_key(je.query(text.split("LIMIT")[0])))
        for text in BATCH:
            want[text] = rows_key(je.query(text))
        runs = {}

        def get(config):
            if config in runs:
                return runs[config]
            sizes, names = configs[config]
            mesh = t_dist.make_mesh(sizes, names)

            def make_engine(warmup, max_capacity):
                kw = {} if max_capacity is None else {
                    "max_capacity": max_capacity}
                return ShardedQueryEngine(
                    shard_store(ts, mesh.n_shards), device="cpu", mesh=mesh,
                    warmup_path=warmup, **kw)

            d = tmp / f"c{config}"
            d.mkdir()
            script = engine_script(d, make_engine, QUERIES, BATCH, UPDATE,
                                   QUERIES["Q1"], RETRY)
            one = drive(make_engine, script)
            ranks = run_ranks(
                d, mesh.n_shards, "engine_prog", data,
                dict(script, save=str(d / "ranks.json")),
                axis_sizes=sizes, axis_names=names,
            )
            runs[config] = (one, ranks)
            return runs[config]

        return js, want, get

    @pytest.mark.parametrize("config", list(configs))
    @pytest.mark.parametrize("name", list(QUERIES))
    def test_rank0_arrays_and_stats_equal_one_process(world, name, config):
        _, want, get = world
        one, ranks = get(config)
        got, ref = ranks[0]["queries"][name], one["queries"][name]
        np.testing.assert_array_equal(got["cols"], ref["cols"])
        np.testing.assert_array_equal(got["valid"], ref["valid"])
        for run in ("cold", "warm", "run"):
            assert got[run] == ref[run], run
        assert got["rows"] == ref["rows"]  # decoded, in order
        assert got["warm"]["n_dispatches"] == 1
        assert got["warm"]["n_compiles"] == 0
        check_rows(rows_key(got["rows"]), *want[name], QUERIES[name])

    @pytest.mark.parametrize("config", list(configs))
    def test_every_rank_makes_the_same_calls(world, config):
        """Each follower's runs report rank 0's ExecStats (so a warm
        repeat is 1 dispatch and 0 compiles on every rank), and every
        rank ends with the one-process engine's plan caches."""
        _, _, get = world
        one, ranks = get(config)
        assert ranks[0]["calls"] == one["calls"]
        for rec in ranks[1:]:
            assert rec["calls"] == ranks[0]["calls"]
        for rec in ranks:
            assert rec["engines"] == one["engines"]
        warm = [c for c in ranks[0]["calls"] if c[0] == "execute"][1::2]
        assert all(s["n_dispatches"] == 1 and s["n_compiles"] == 0
                   for _, (s,) in warm)

    @pytest.mark.parametrize("config", list(configs))
    def test_each_rank_stages_its_own_shard(world, config):
        """Q9's scans on rank r hold shard r's matches alone, at the
        bucket shared by every shard."""
        _, _, get = world
        _, ranks = get(config)
        for r, rec in enumerate(ranks):
            for rows, cap, counts, bucket in rec["placement"]:
                assert len(counts) == len(ranks)
                assert rows == counts[r] and cap == bucket >= max(counts)

    @pytest.mark.parametrize("config", list(configs))
    def test_forced_retry_and_memory_error_on_every_rank(world, config):
        _, want, get = world
        one, ranks = get(config)
        for name in RETRY:
            rows, stats = ranks[0]["queries"][name]["retry"]
            assert stats["n_retries"] >= 1
            assert (rows, stats) == one["queries"][name]["retry"]
            assert rows_key(rows) == want[name][0]
            assert ranks[0]["queries"][name]["capped"] == "MemoryError"
        failed = [c for c in ranks[0]["calls"] if c[1] == "MemoryError"]
        assert len(failed) == len(RETRY)

    @pytest.mark.parametrize("config", list(configs))
    def test_run_batch_update_and_the_query_after(world, config):
        _, want, get = world
        one, ranks = get(config)
        r0 = ranks[0]
        assert r0["batches"] == one["batches"]
        cold, warm = r0["batches"]
        assert [g[2] for g in warm["groups"]] == [1]  # one stacked dispatch
        for text, rows in zip(BATCH, warm["rows"]):
            assert rows_key(rows) == want[text]
        assert r0["update"] == one["update"] and r0["update"][0] == 2
        assert r0["after_update"] == one["after_update"]
        assert {"?x": NEW} in r0["after_update"]

    @pytest.mark.parametrize("name", oracle)
    def test_rank0_rows_equal_the_oracle(world, name):
        js, _, get = world
        text = QUERIES[name]
        want = rows_key(reference_rows(js, j_parse(text)))
        for config in configs:
            check_rows(rows_key(get(config)[1][0]["queries"][name]["rows"]),
                       want, want, text)

    return (world, test_rank0_arrays_and_stats_equal_one_process,
            test_every_rank_makes_the_same_calls,
            test_each_rank_stages_its_own_shard,
            test_forced_retry_and_memory_error_on_every_rank,
            test_run_batch_update_and_the_query_after,
            test_rank0_rows_equal_the_oracle)


(world, test_rank0_arrays_and_stats_equal_one_process,
 test_every_rank_makes_the_same_calls,
 test_each_rank_stages_its_own_shard,
 test_forced_retry_and_memory_error_on_every_rank,
 test_run_batch_update_and_the_query_after,
 test_rank0_rows_equal_the_oracle) = engine_module_tests(
    {"2": ((2,), ("shards",)), "4": ((4,), ("shards",)),
     "2x2": ((2, 2), ("pod", "data"))},
    scale=2, oracle=("Q4", "F1", "J1", "J2", "S1"),
)
