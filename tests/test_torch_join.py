"""Every operator of the port's core/mr_join.py, core/matrix_join.py and
core/segments.py against the JAX operator, on seeded random relations with
padding rows. Arrays must be equal in full and in order — truncation at
capacity, totals and overflow flags included."""
import jax  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import matrix_join as j_mx
from repro.core import mr_join as j_mr
from repro.core import segments as j_seg
from repro.core.relation import Relation as JRelation
from repro_torch.core import matrix_join as t_mx
from repro_torch.core import mr_join as t_mr
from repro_torch.core import segments as t_seg
from repro_torch.core.relation import Relation as TRelation
from repro_torch.core.relation import pad_to


def _pair(schema, cols, valid):
    cols = np.asarray(cols, np.int32)
    valid = np.asarray(valid, bool)
    return (
        JRelation(tuple(schema), jnp.asarray(cols), jnp.asarray(valid)),
        TRelation(tuple(schema), torch.from_numpy(cols), torch.from_numpy(valid)),
    )


def _random(rng, schema, n, hi, p_valid=0.85):
    return _pair(
        schema,
        rng.randint(0, hi, size=(n, len(schema))),
        rng.rand(n) < p_valid,
    )


def _same(j, t) -> None:
    """Equal arrays (or relations, or tuples of them), in order."""
    if isinstance(j, JRelation):
        assert tuple(j.schema) == tuple(t.schema)
        _same(j.cols, t.cols)
        _same(j.valid, t.valid)
        return
    if isinstance(j, (tuple, list)):
        assert len(j) == len(t)
        for a, b in zip(j, t):
            _same(a, b)
        return
    want = np.asarray(j)
    got = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _join_inputs(seed, n_l=50, n_r=41, hi=5, two_keys=False):
    rng = np.random.RandomState(seed)
    ls = ("?k", "?m", "?a") if two_keys else ("?k", "?a")
    rs = ("?k", "?m", "?b") if two_keys else ("?k", "?b")
    return _random(rng, ls, n_l, hi), _random(rng, rs, n_r, hi)


JOIN_CASES = [
    (seed, cap, two)
    for seed in (0, 1)
    for cap in (1, 3, 16, 64, 100, 4096)
    for two in (False, True)
]


@pytest.mark.parametrize("seed,capacity,two_keys", JOIN_CASES)
def test_mr_join(seed, capacity, two_keys):
    (jl, tl), (jr, tr) = _join_inputs(seed, two_keys=two_keys)
    _same(j_mr.mr_join(jl, jr, capacity), t_mr.mr_join(tl, tr, capacity))
    _same(j_mr.mr_join_count(jl, jr), t_mr.mr_join_count(tl, tr))


@pytest.mark.parametrize("seed,capacity,two_keys", JOIN_CASES)
def test_matrix_join(seed, capacity, two_keys):
    (jl, tl), (jr, tr) = _join_inputs(seed, two_keys=two_keys)
    _same(j_mx.matrix_join(jl, jr, capacity), t_mx.matrix_join(tl, tr, capacity))


@pytest.mark.parametrize("capacity", [1, 3, 16, 64, 4096])
def test_matrix_join_matches_mr_join_exactly(capacity):
    """Bit-identical output (order included) at every capacity, including
    overflowing ones — the regrow loop depends on exact truncation."""
    rng = np.random.RandomState(11)
    _, left = _pair(("?k", "?a"), rng.randint(0, 5, size=(50, 2)), np.ones(50))
    _, right = _pair(("?k", "?b"), rng.randint(0, 5, size=(41, 2)), np.ones(41))
    out_m, tot_m, ovf_m = t_mr.mr_join(left, right, capacity)
    out_x, tot_x, ovf_x = t_mx.matrix_join(left, right, capacity)
    assert int(tot_m) == int(tot_x)
    assert bool(ovf_m) == bool(ovf_x)
    np.testing.assert_array_equal(out_m.to_numpy(), out_x.to_numpy())


@pytest.mark.parametrize("seed,capacity", [(2, 8), (3, 512), (4, 37)])
def test_left_joins(seed, capacity):
    (jl, tl), (jr, tr) = _join_inputs(seed, n_l=40, n_r=30, hi=9)
    _same(j_mr.left_join(jl, jr, capacity), t_mr.left_join(tl, tr, capacity))
    _same(
        j_mx.matrix_left_join(jl, jr, capacity),
        t_mx.matrix_left_join(tl, tr, capacity),
    )
    _same(j_mr.semijoin_mask(jl, jr), t_mr.semijoin_mask(tl, tr))


@pytest.mark.parametrize("capacity", [60, 64, 100])
def test_cross_join_and_compact(capacity):
    rng = np.random.RandomState(5)
    jl, tl = _random(rng, ("?a",), 6, 9)
    jr, tr = _random(rng, ("?b", "?c"), 10, 9)
    j_out = j_mr.cross_join(jl, jr, capacity)
    t_out = t_mr.cross_join(tl, tr, capacity)
    _same(j_out, t_out)
    _same(j_mr.compact(j_out[0]), t_mr.compact(t_out[0]))


@pytest.mark.parametrize("n,n_cols", [(1, 1), (64, 1), (200, 2), (300, 3)])
def test_distinct(n, n_cols):
    rng = np.random.RandomState(n + n_cols)
    jr, tr = _random(rng, tuple(f"?v{i}" for i in range(n_cols)), n, 4, 0.7)
    _same(j_mr.distinct(jr), t_mr.distinct(tr))


def test_filter_masks_union_and_slice():
    rng = np.random.RandomState(7)
    n = 120
    cols = rng.randint(-1, 12, size=(n, 3))  # -1 = UNBOUND
    jr, tr = _pair(("?x", "?y", "?z"), cols, rng.rand(n) < 0.9)
    num = np.full(16, np.nan, np.float32)
    num[:10] = rng.rand(10).astype(np.float32) * 10
    num[4] = num[5]  # equal values under distinct ids
    ci = np.array([3, 7], np.int32)
    cf = np.array([4.5, 2.0], np.float32)
    j_args = (jnp.asarray(ci), jnp.asarray(cf), jnp.asarray(num))
    t_args = (torch.from_numpy(ci), torch.from_numpy(cf), torch.from_numpy(num))
    exprs = [
        ("cmp", "?x", "=", "id", 0),
        ("cmp", "?x", "!=", "id", 1),
        ("cmp", "?x", "=", "var", "?y"),
        ("cmp", "?x", "!=", "var", "?y"),
        ("cmp", "?x", "<", "var", "?z"),
        ("cmp", "?y", ">=", "num", 0),
        ("cmp", "?z", "<=", "num", 1),
        ("cmp", "?z", "=", "num", 1),
        ("or", (("cmp", "?x", ">", "num", 0), ("cmp", "?y", "=", "id", 0))),
        ("and", (("cmp", "?x", "!=", "var", "?z"),
                 ("or", (("cmp", "?z", "<", "num", 0),
                         ("cmp", "?y", "=", "var", "?z"))))),
    ]
    for e in exprs:
        _same(j_mr.expr_mask(jr, e, *j_args), t_mr.expr_mask(tr, e, *t_args))
    _same(
        j_mr.filter_mask(jr, tuple(exprs[4:7]), *j_args),
        t_mr.filter_mask(tr, tuple(exprs[4:7]), *t_args),
    )
    jr2, tr2 = _random(rng, ("?y", "?w"), 30, 12)
    schema = ("?x", "?y", "?z", "?w")
    _same(j_mr.union_all([jr, jr2], schema), t_mr.union_all([tr, tr2], schema))
    for off, lim in ((0, 5), (3, 1000), (50, 0), (7, 7)):
        _same(
            j_mr.slice_valid(jr, jnp.int32(off), jnp.int32(lim)),
            t_mr.slice_valid(tr, torch.tensor(off, dtype=torch.int32),
                             torch.tensor(lim, dtype=torch.int32)),
        )


def test_segment_helpers():
    rng = np.random.RandomState(8)
    lk = rng.randint(0, 4, size=(30, 2)).astype(np.int32)
    rk = rng.randint(0, 4, size=(25, 2)).astype(np.int32)
    lk[::5] = 2**31 - 1
    _same(
        j_seg.dense_rank_two_sided(jnp.asarray(lk), jnp.asarray(rk)),
        t_seg.dense_rank_two_sided(torch.from_numpy(lk), torch.from_numpy(rk)),
    )
    ids = np.sort(rng.randint(0, 6, size=40)).astype(np.int32)
    _same(
        j_seg.segment_offsets_from_sorted(jnp.asarray(ids), 8),
        t_seg.segment_offsets_from_sorted(torch.from_numpy(ids), 8),
    )
    counts = np.array([2, 0, 3, 0, 1, 4], np.int32)
    for total in (5, 10, 14):
        _same(
            j_seg.counts_to_segment_ids(jnp.asarray(counts), total),
            t_seg.counts_to_segment_ids(torch.from_numpy(counts), total),
        )


def test_pad_to_keeps_rows_and_masks_padding():
    rng = np.random.RandomState(9)
    _, rel = _random(rng, ("?a", "?b"), 5, 9)
    padded = pad_to(rel, 8)
    assert padded.capacity == 8
    np.testing.assert_array_equal(padded.to_numpy(), rel.to_numpy())
    assert not padded.valid[5:].any()
    assert pad_to(rel, 5) is rel
