"""The exchanges of core/distributed.py across processes (one shard per
rank, gloo on the CPU) at 2, 4 and 8 ranks and on a 2 x 2 mesh: each
rank's outputs equal the one-process functions' block of its shard, and
the distributed join's rows, gathered from every rank, equal the numpy
oracle join (tests/distributed/dist_join_prog.py's `oracle_join`).

The reference's shard_map exchanges fail on this JAX version, so the
one-process functions stand in for them; test_torch_sharded_exec.py holds
those to a numpy re-derivation."""
import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch  # noqa: F401

from repro_torch.core import distributed as dj

from test_torch_dist_ranks import (
    LANES, SEEDS, exchange_outputs, join_inputs, join_outputs, run_ranks,
)

# name -> (mesh axis sizes, axis names)
CONFIGS = {
    "2": ((2,), ("shards",)),
    "4": ((4,), ("shards",)),
    "8": ((8,), ("shards",)),
    "2x2": ((2, 2), ("pod", "data")),
}
# outputs every process holds whole; the others are per shard
GLOBAL = ("gather_shards", "gather_relation")


def oracle_join(l_schema, l_rows, r_schema, r_rows):
    shared = [v for v in l_schema if v in r_schema]
    r_extra = [v for v in r_schema if v not in l_schema]
    out = []
    for lr in l_rows:
        for rr in r_rows:
            if all(lr[l_schema.index(v)] == rr[r_schema.index(v)]
                   for v in shared):
                out.append(tuple(lr) + tuple(rr[r_schema.index(v)]
                                             for v in r_extra))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each configuration's rank results, spawned once, and the one-process
    outputs beside them."""
    cache = {}

    def get(config):
        if config not in cache:
            sizes, names = CONFIGS[config]
            ranks = run_ranks(
                tmp_path_factory.mktemp(f"x{config}"), int(np.prod(sizes)),
                "exchange_prog", axis_sizes=sizes, axis_names=names,
            )
            mesh = dj.make_mesh(sizes, names)
            one = {seed: {"exchanges": exchange_outputs(mesh, seed),
                          "join": join_outputs(mesh, seed)}
                   for seed in SEEDS}
            cache[config] = (ranks, one)
        return cache[config]

    return get


def _leaves(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("config", list(CONFIGS))
def test_exchanges_equal_the_one_process_functions(runs, config, seed):
    ranks, one = runs(config)
    s = len(ranks)
    want = one[seed]["exchanges"]
    for r, got in enumerate(ranks):
        got = got[seed]["exchanges"]
        assert set(got) == set(want)
        for key in want:
            for g, w in zip(_leaves(got[key]), _leaves(want[key])):
                if key not in GLOBAL:
                    w = w.reshape(LANES, s, *w.shape[1:])[:, r]
                assert g.dtype == w.dtype, key
                np.testing.assert_array_equal(g, w, err_msg=f"{key} rank {r}")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("config", list(CONFIGS))
def test_distributed_join_equals_one_process_and_the_oracle(runs, config,
                                                            seed):
    ranks, one = runs(config)
    s = len(ranks)
    cols, valid, totals, ov = one[seed]["join"]
    cap = cols.shape[0] // s
    rows = []
    for r, got in enumerate(ranks):
        g_cols, g_valid, g_totals, g_ov = got[seed]["join"]
        np.testing.assert_array_equal(g_cols, cols[r * cap:(r + 1) * cap])
        np.testing.assert_array_equal(g_valid, valid[r * cap:(r + 1) * cap])
        np.testing.assert_array_equal(g_totals, totals[r:r + 1])
        np.testing.assert_array_equal(g_ov, ov[r:r + 1])
        assert not g_ov.any()
        rows += map(tuple, g_cols[g_valid].tolist())
    l_rows, r_rows, _, _ = join_inputs(s, seed)
    want = sorted(oracle_join(("?k", "?a"), l_rows.tolist(),
                              ("?k", "?b"), r_rows.tolist()))
    assert sorted(rows) == want
    assert int(totals.sum()) == len(want)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_a_small_bucket_overflows_on_every_rank_alike(runs, config):
    """The shuffle at 2 rows a destination drops rows: each rank's flag
    and exact need equal the one-process shuffle's for its shard."""
    ranks, one = runs(config)
    s = len(ranks)
    _, _, ov, need = one[SEEDS[0]]["exchanges"]["shuffle_by_key/overflow"]
    assert ov.any() and (need > 2).any()
    for r, got in enumerate(ranks):
        g_ov, g_need = got[SEEDS[0]]["exchanges"]["shuffle_by_key/overflow"][2:]
        np.testing.assert_array_equal(
            g_ov, ov.reshape(LANES, s, -1)[:, r])
        np.testing.assert_array_equal(
            g_need, need.reshape(LANES, s, -1)[:, r])
