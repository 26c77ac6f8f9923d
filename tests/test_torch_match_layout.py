"""match_layout's two designs on the CPU, held to the JAX package: the
sort-and-search identities (the port's `ref.match_layout_sorted`, and a
numpy emulation of the CUDA path's radix passes and searches) and the
compare path's 32-row blocks (a numpy emulation of its row and column
blocks and warp reduce-scatter), against the jnp reference, the Pallas
kernel in interpret mode and the port's dense plain version. Every output
is int32, so every comparison is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mr_join as j_mr
from repro.core.relation import Relation as JRelation
from repro.kernels.spmm_join import ops as j_sm_ops
from repro.kernels.spmm_join import ref as j_sm_ref
from repro_torch.core import matrix_join as t_mx
from repro_torch.core.relation import Relation as TRelation
from repro_torch.kernels.spmm_join import ops as t_sm_ops
from repro_torch.kernels.spmm_join import ref as t_sm_ref

INVALID_LEFT = 2**31 - 1
INVALID_RIGHT = 2**31 - 2
INT32_MIN = -(2**31)


def _side_keys(kind, n, rng, sentinel):
    if kind == "ties":
        return rng.randint(0, 4, size=n).astype(np.int32)
    if kind == "equal":
        return np.full(n, 5, np.int32)
    if kind == "int32_min":  # INT32_MIN among heavy ties
        k = rng.randint(-3, 3, size=n).astype(np.int32)
        k[rng.rand(n) < 0.3] = INT32_MIN
        return k
    if kind == "sentinels":  # the side's invalid-row sentinel, INT32_MIN
        k = rng.randint(0, 4, size=n).astype(np.int32)
        k[rng.rand(n) < 0.25] = sentinel
        k[rng.rand(n) < 0.05] = INT32_MIN
        return k
    return rng.randint(INT32_MIN, INVALID_LEFT, size=n,  # "random"
                       dtype=np.int64).astype(np.int32)


def _layout_keys(kind, n_l, n_r, seed):
    rng = np.random.RandomState(seed)
    lk = _side_keys(kind, n_l, rng, INVALID_LEFT)
    rk = _side_keys(kind, n_r, rng, INVALID_RIGHT)
    if kind == "random":  # some matches among the random keys
        rk[: n_r // 2] = rng.choice(lk, size=n_r // 2)
    return lk, rk


def _held_to_jax(got, lk, rk, pallas=True):
    """`got` (four int32 arrays) equals the jnp reference, the port's dense
    plain version and, with `pallas`, the Pallas kernel in interpret
    mode."""
    ref = j_sm_ref.match_layout(jnp.asarray(lk), jnp.asarray(rk))
    plain = t_sm_ops.match_layout(torch.from_numpy(lk), torch.from_numpy(rk))
    for g, r, p in zip(got, ref, plain):
        g = np.asarray(g)
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(r))
        np.testing.assert_array_equal(g, p.numpy())
    if not pallas:
        return
    kern = [np.asarray(x).copy() for x in j_sm_ops.match_layout(
        jnp.asarray(lk), jnp.asarray(rk), use_kernel=True, interpret=True)]
    # The Pallas wrapper pads the right keys with INVALID_RIGHT, which
    # `first` of an invalid-left row then also counts (ROADMAP Queue 3; no
    # join reads it).
    invalid = lk == INVALID_LEFT
    kern[1][invalid] = np.asarray(ref[1])[invalid]
    for g, k in zip(got, kern):
        np.testing.assert_array_equal(np.asarray(g), k)


_KINDS = ["ties", "equal", "int32_min", "sentinels", "random"]
_SHAPES = [(1, 1), (1, 9), (9, 1), (300, 7), (7, 300), (257, 130)]


# ------------------------------------------- the sorted identities (oracle) --
@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("n_l,n_r", _SHAPES)
def test_sorted_identities_match_pallas_and_ref(n_l, n_r, kind):
    lk, rk = _layout_keys(kind, n_l, n_r, n_l * 131 + n_r)
    got = t_sm_ref.match_layout_sorted(torch.from_numpy(lk),
                                       torch.from_numpy(rk))
    _held_to_jax([g.numpy() for g in got], lk, rk)


@pytest.mark.parametrize("kind", ["ties", "sentinels", "int32_min"])
def test_sorted_identities_over_stacked_lanes(kind):
    """(lanes, n) keys lay out each lane on its own, as the jnp reference
    vmapped over the lanes does."""
    lanes, n_l, n_r = 3, 70, 40
    pairs = [_layout_keys(kind, n_l, n_r, 17 + w) for w in range(lanes)]
    lk = np.stack([p[0] for p in pairs])
    rk = np.stack([p[1] for p in pairs])
    got = t_sm_ref.match_layout_sorted(torch.from_numpy(lk),
                                       torch.from_numpy(rk))
    ref = jax.vmap(j_sm_ref.match_layout)(jnp.asarray(lk), jnp.asarray(rk))
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32 and g.shape == (lanes, r.shape[1])
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for w in range(lanes):
        _held_to_jax([g[w].numpy() for g in got], lk[w], rk[w], pallas=False)


def test_b_wraps_as_the_reference_int32_sum():
    """counts * occ passes 2^31 (65,536 matches a row, up to 32,769 earlier
    equal rows): b wraps mod 2^32 as the jnp reference's int32 sum and the
    dense plain version do."""
    n_l, n_r = 32770, 65536
    lk = np.full(n_l, 7, np.int32)
    rk = np.full(n_r, 7, np.int32)
    got = t_sm_ref.match_layout_sorted(torch.from_numpy(lk),
                                       torch.from_numpy(rk))
    assert int(got[0][-1]) * (n_l - 1) > 2**31  # the product passes 2^31
    assert int(got[2][-1]) < 0  # and wrapped
    _held_to_jax([g.numpy() for g in got], lk, rk, pallas=False)


# ------------------------------------------------ the card's designs, in numpy --
# Test-only emulations of csrc/match_layout.cu's two paths, at small tiles
# so every edge of the decomposition shows.

def _fold(acc):
    """The warp reduce-scatter (include/compare_fold.cuh): acc[lane, r] of
    one warp -> the warp's count of row `lane`, by shuffles of distance
    16 .. 1."""
    a = acc.copy()
    s = 16
    while s >= 1:
        nxt = a.copy()
        for lane in range(32):
            partner = lane ^ s
            for k in range(s):
                recv = a[partner, k] if partner & s else a[partner, k + s]
                keep = a[lane, k + s] if lane & s else a[lane, k]
                nxt[lane, k] = keep + recv
        a = nxt
        s //= 2
    return a[:, 0]


def _block_sum(acc, threads):
    """Per-row counts of a block: each warp's fold, then the warps' sum."""
    return np.sum([_fold(acc[32 * w:32 * w + 32])
                   for w in range(threads // 32)], axis=0)


def _wrap32(x):
    return ((np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31).astype(np.int32)


def _compare_path_emulation(lk, rk, threads):
    """Row blocks of 32 left keys: thread t compares the right keys t,
    t + threads, ... with every live row (eq, lt), then, when a row of the
    block matched, the left keys before the block (eq) and its own key
    (eq and a lower index); column blocks of 32 right keys compare the
    left keys (eq), or, up to `threads` left keys, column blocks of
    `threads` right keys, a thread each, compare all the left keys. Rows
    past a partial block's end count nothing."""
    n_l, n_r = len(lk), len(rk)
    lk64, rk64 = lk.astype(np.int64), rk.astype(np.int64)
    counts, first, b = (np.full(n_l, -1, np.int64) for _ in range(3))
    cl = np.full(n_r, -1, np.int64)
    lanes = np.arange(32)
    for base in range(0, n_l, 32):
        rows = min(32, n_l - base)
        live = lanes < rows
        key = np.zeros(32, np.int64)
        key[:rows] = lk64[base:base + rows]
        eq = np.zeros((threads, 32), np.int64)
        lt = np.zeros((threads, 32), np.int64)
        for t in range(threads):
            v = rk64[t::threads, None]
            eq[t] = ((v == key) & live).sum(0)
            lt[t] = ((v < key) & live).sum(0)
        c = _block_sum(eq, threads)[:rows]
        counts[base:base + rows] = c
        first[base:base + rows] = _block_sum(lt, threads)[:rows]
        if not (c > 0).any():  # the occ pass is skipped
            b[base:base + rows] = 0
            continue
        occ = np.zeros((threads, 32), np.int64)
        for t in range(threads):
            occ[t] = ((lk64[t:base:threads, None] == key) & live).sum(0)
            if t < rows:
                occ[t] += (lk64[base + t] == key) & (t < lanes) & live
        b[base:base + rows] = c * _block_sum(occ, threads)[:rows]
    if n_l <= threads:  # a right key a thread
        for j in range(n_r):
            cl[j] = int((lk64 == rk64[j]).sum())
        return [_wrap32(x) for x in (counts, first, b, cl)]
    for base in range(0, n_r, 32):
        cols = min(32, n_r - base)
        live = lanes < cols
        key = np.zeros(32, np.int64)
        key[:cols] = rk64[base:base + cols]
        eq = np.zeros((threads, 32), np.int64)
        for t in range(threads):
            eq[t] = ((lk64[t::threads, None] == key) & live).sum(0)
        cl[base:base + cols] = _block_sum(eq, threads)[:cols]
    return [_wrap32(x) for x in (counts, first, b, cl)]


@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("n_l,n_r,threads", [
    (1, 1, 32), (1, 9, 32), (31, 33, 32), (32, 64, 64), (33, 5, 32),
    (100, 70, 64), (70, 100, 32), (70, 100, 256)])
def test_compare_path_design_matches_pallas_and_plain(n_l, n_r, threads,
                                                      kind):
    lk, rk = _layout_keys(kind, n_l, n_r, n_l * 7 + n_r + threads)
    _held_to_jax(_compare_path_emulation(lk, rk, threads), lk, rk)


def _bound(a, lo, hi, key, upper):
    """The search kernel's bound_of: the first index in [lo, hi) whose
    value is >= key (upper: > key), else hi."""
    while lo < hi:
        mid = lo + ((hi - lo) >> 1)
        if (a[mid] <= key) if upper else (a[mid] < key):
            lo = mid + 1
        else:
            hi = mid
    return lo


def _sorted_path_emulation(lk, rk, warps, items):
    """Both sides sorted on (key, index) by the radix passes, then a
    search per sorted position, written to that position's row."""
    from test_torch_sort_segment import _radix_sort_emulation

    n_l, n_r = len(lk), len(rk)
    lk_sorted, lk_row = _radix_sort_emulation(
        lk, np.arange(n_l, dtype=np.int32), warps, items)
    rk_sorted, rk_row = _radix_sort_emulation(
        rk, np.arange(n_r, dtype=np.int32), warps, items)
    counts, first, b = (np.full(n_l, -1, np.int64) for _ in range(3))
    for p in range(n_l):
        key, i = lk_sorted[p], lk_row[p]
        first[i] = _bound(rk_sorted, 0, n_r, key, False)
        counts[i] = _bound(rk_sorted, first[i], n_r, key, True) - first[i]
        b[i] = counts[i] * (p - _bound(lk_sorted, 0, p, key, False))
    cl = np.full(n_r, -1, np.int64)
    for q in range(n_r):
        lo = _bound(lk_sorted, 0, n_l, rk_sorted[q], False)
        cl[rk_row[q]] = _bound(lk_sorted, lo, n_l, rk_sorted[q], True) - lo
    return [_wrap32(x) for x in (counts, first, b, cl)]


@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("n_l,n_r,warps,items", [
    (1, 1, 1, 1), (300, 7, 1, 2), (7, 300, 2, 1), (257, 130, 2, 2)])
def test_sorted_path_design_matches_pallas_and_plain(n_l, n_r, warps, items,
                                                     kind):
    lk, rk = _layout_keys(kind, n_l, n_r, n_l * 3 + n_r + warps)
    _held_to_jax(_sorted_path_emulation(lk, rk, warps, items), lk, rk)


# ------------------------------------------ the matrix join past 2^31 codes --
def _ranks(keys):
    """Stable sorted positions (the plain sort_ranks, without its n^2
    compares)."""
    order = torch.sort(keys, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(keys.shape[0])
    return rank.to(torch.int32)


def test_matrix_join_keeps_mr_order_past_int32_codes(monkeypatch):
    """The matrix join's slot code first[i] * n_l + i passes 2^31 once
    n_l * n_r does (here 2^16 x 2^16 rows, ~65k matches); its rows must
    still come in mr_join's order, the JAX reference's mr_join rows. The
    layout comes from the sorted oracle (the dense plain version would make
    2^33 compares)."""
    monkeypatch.setattr(t_mx.spmm_ops, "match_layout",
                        t_sm_ref.match_layout_sorted)
    monkeypatch.setattr(t_mx.spmm_ops, "sort_ranks", _ranks)
    rng = np.random.RandomState(0)
    n = 1 << 16
    lc = rng.randint(0, n, size=(n, 2)).astype(np.int32)
    rc = rng.randint(0, n, size=(n, 2)).astype(np.int32)
    lv = rng.rand(n) < 0.9
    rv = rng.rand(n) < 0.9
    capacity = 1 << 17
    got, total, over = t_mx.matrix_join(
        TRelation(("?k", "?a"), torch.from_numpy(lc), torch.from_numpy(lv)),
        TRelation(("?k", "?b"), torch.from_numpy(rc), torch.from_numpy(rv)),
        capacity)
    want, w_total, w_over = j_mr.mr_join(
        JRelation(("?k", "?a"), jnp.asarray(lc), jnp.asarray(lv)),
        JRelation(("?k", "?b"), jnp.asarray(rc), jnp.asarray(rv)),
        capacity)
    assert int(total) == int(w_total) > 50_000 and not bool(over)
    assert not bool(w_over)
    assert got.schema == tuple(want.schema)
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(want.cols))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
