"""The port's kernel ops on the CPU (their plain versions) against the JAX
ops: the Pallas kernels in interpret mode and the jnp references. Every
output is int32 or bool, so every comparison is exact."""
import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pair_expand import ops as j_pe_ops
from repro.kernels.pair_expand import ref as j_pe_ref
from repro.kernels.spmm_join import ops as j_sm_ops
from repro.kernels.spmm_join import ref as j_sm_ref
from repro_torch.kernels.pair_expand import ops as t_pe_ops
from repro_torch.kernels.spmm_join import ops as t_sm_ops

INVALID_LEFT = 2**31 - 1
INVALID_RIGHT = 2**31 - 2


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ pair expand --
@pytest.mark.parametrize(
    "n_left,capacity",
    [(1, 1), (1, 1024), (2, 7), (5, 1024), (700, 2048), (700, 1500),
     (1024, 4096), (333, 3000)],
)
def test_pair_expand_matches_pallas_and_ref(n_left, capacity):
    rng = np.random.RandomState(n_left + capacity)
    counts = rng.randint(0, 5, size=n_left).astype(np.int32)
    counts[::3] = 0  # empty groups
    prefix = np.cumsum(counts).astype(np.int32)
    got = t_pe_ops.pair_expand(
        torch.from_numpy(prefix), torch.from_numpy(counts), capacity
    )
    kern = j_pe_ops.pair_expand(
        jnp.asarray(prefix), jnp.asarray(counts), capacity,
        use_kernel=True, interpret=True,
    )
    ref = j_pe_ref.pair_expand(jnp.asarray(prefix), jnp.asarray(counts), capacity)
    for g, k, r in zip(got, kern, ref):
        _eq(g, k)
        _eq(g, r)


def test_pair_expand_enumerates_all_pairs():
    counts = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    prefix = torch.cumsum(counts, 0, dtype=torch.int32)
    i, off, valid = t_pe_ops.pair_expand(prefix, counts, 10)
    pairs = {(int(a), int(b)) for a, b, v in zip(i, off, valid) if v}
    assert pairs == {(0, 0), (0, 1), (2, 0), (2, 1), (2, 2), (3, 0)}


# ----------------------------------------------------------- match layout --
def _keys(rng, n, hi, sentinel):
    k = rng.randint(0, hi, size=n).astype(np.int32)
    k[rng.rand(n) < 0.15] = sentinel
    return k


@pytest.mark.parametrize(
    "n_l,n_r",
    [(1, 1), (1, 5), (4, 1), (2, 3), (40, 7), (130, 70), (700, 80),
     (1024, 256), (1100, 300)],
)
def test_match_layout_matches_pallas_and_ref(n_l, n_r):
    rng = np.random.RandomState(n_l * 31 + n_r)
    lk = _keys(rng, n_l, 11, INVALID_LEFT)
    rk = _keys(rng, n_r, 11, INVALID_RIGHT)
    got = t_sm_ops.match_layout(torch.from_numpy(lk), torch.from_numpy(rk))
    kern = j_sm_ops.match_layout(
        jnp.asarray(lk), jnp.asarray(rk), use_kernel=True, interpret=True
    )
    ref = j_sm_ref.match_layout(jnp.asarray(lk), jnp.asarray(rk))
    for g, r in zip(got, ref):
        _eq(g, r)
    # The Pallas wrapper pads the right keys with INVALID_RIGHT, which is
    # below INVALID_LEFT: `first` of an invalid-left row then also counts
    # the padding. Such rows have no matches, so no join reads it; every
    # other output equals the kernel's.
    first_k = np.asarray(kern[1]).copy()
    first_k[lk == INVALID_LEFT] = np.asarray(ref[1])[lk == INVALID_LEFT]
    for g, k in zip(got, (kern[0], first_k, kern[2], kern[3])):
        _eq(g, k)


def test_match_layout_above_one_shot_cap():
    """Both the jnp reference and the port's plain version split the
    compares into row blocks here (n_l * n_r > ONE_SHOT_ELEMS)."""
    rng = np.random.RandomState(3)
    n_l = j_sm_ref.ONE_SHOT_ELEMS // 64 + 200
    lk = _keys(rng, n_l, 13, INVALID_LEFT)
    rk = _keys(rng, 64, 13, INVALID_RIGHT)
    got = t_sm_ops.match_layout(torch.from_numpy(lk), torch.from_numpy(rk))
    ref = j_sm_ref.match_layout(jnp.asarray(lk), jnp.asarray(rk))
    for g, r in zip(got, ref):
        _eq(g, r)


def test_match_layout_per_row_identity():
    """The CUDA kernel's identity b[i] = counts[i] * #{i' < i : lk[i'] ==
    lk[i]} holds against the carried column sums, sentinels included."""
    rng = np.random.RandomState(9)
    lk = _keys(rng, 500, 7, INVALID_LEFT)
    rk = _keys(rng, 90, 7, INVALID_RIGHT)
    counts, _, b, _ = t_sm_ops.match_layout(
        torch.from_numpy(lk), torch.from_numpy(rk)
    )
    occ = np.array([(lk[:i] == lk[i]).sum() for i in range(len(lk))])
    np.testing.assert_array_equal(b.numpy(), counts.numpy() * occ)


# ------------------------------------------------------------- sort ranks --
@pytest.mark.parametrize("n", [1, 2, 17, 255, 256, 1000, 1024, 1300])
def test_sort_ranks_matches_pallas_and_ref(n):
    rng = np.random.RandomState(n)
    keys = rng.randint(0, max(2, n // 3), size=n).astype(np.int32)
    keys[rng.rand(n) < 0.1] = INVALID_RIGHT
    got = t_sm_ops.sort_ranks(torch.from_numpy(keys))
    kern = j_sm_ops.sort_ranks(jnp.asarray(keys), use_kernel=True,
                               interpret=True)
    ref = j_sm_ref.sort_ranks(jnp.asarray(keys))
    _eq(got, kern)
    _eq(got, ref)
    order = np.argsort(keys, kind="stable")
    want = np.empty(n, np.int32)
    want[order] = np.arange(n)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------- edges of the H100 designs --
# The plain versions, which the kernels are held to bit for bit on the
# card, against the Pallas kernels in interpret mode and the jnp
# references at the inputs that the card's designs treat apart: long runs
# of zero-count rows (a merge-path tile that holds rows and no slots), a
# total far below the capacity (tiles wholly past the total), a total
# above the capacity, one row holding every slot; sort keys all equal,
# INT32_MIN, and the invalid-row sentinels.
INT32_MIN = -(2**31)


def _expand_case(case, rng):
    """(counts, capacity) of one edge case."""
    if case == "zero_runs":  # 90% zero counts, one run of 3000 zeros
        counts = rng.randint(1, 5, size=5000) * (rng.rand(5000) < 0.1)
        counts[1000:4000] = 0
        return counts, 2048
    if case == "total_third":  # total = capacity / 3
        counts = rng.randint(0, 3, size=900)
        return counts, 3 * int(counts.sum())
    if case == "over_capacity":  # the total exceeds the capacity
        counts = rng.randint(0, 9, size=800)
        return counts, int(counts.sum()) // 2 + 1
    if case == "one_group":  # one row holds every slot
        counts = np.zeros(300, np.int64)
        counts[123] = 2500
        return counts, 3000
    if case == "all_zero":
        return np.zeros(64, np.int64), 1000
    if case == "few_slots":  # many left rows, a dozen matches, capacity 16
        counts = np.zeros(5000, np.int64)
        counts[rng.choice(5000, 12, replace=False)] = 1
        return counts, 16
    return rng.randint(0, 7, size=1500), 4096  # "uniform"


_EXPAND_CASES = ["uniform", "zero_runs", "total_third", "over_capacity",
                 "one_group", "all_zero", "few_slots"]


@pytest.mark.parametrize("case", _EXPAND_CASES)
def test_pair_expand_edges_match_pallas_and_ref(case):
    rng = np.random.RandomState(len(case))
    counts, capacity = _expand_case(case, rng)
    counts = counts.astype(np.int32)
    prefix = np.cumsum(counts).astype(np.int32)
    got = t_pe_ops.pair_expand(
        torch.from_numpy(prefix), torch.from_numpy(counts), capacity
    )
    kern = j_pe_ops.pair_expand(
        jnp.asarray(prefix), jnp.asarray(counts), capacity,
        use_kernel=True, interpret=True,
    )
    ref = j_pe_ref.pair_expand(jnp.asarray(prefix), jnp.asarray(counts), capacity)
    for g, k, r in zip(got, kern, ref):
        _eq(g, k)
        _eq(g, r)


def _sort_keys(kind, n, rng):
    if kind == "equal":
        return np.full(n, 5, np.int32)
    if kind == "int32_min":  # INT32_MIN among heavy ties
        k = rng.randint(-3, 3, size=n).astype(np.int32)
        k[rng.rand(n) < 0.3] = INT32_MIN
        return k
    if kind == "sentinels":  # both invalid-row sentinels, and INT32_MIN
        k = rng.randint(0, 4, size=n).astype(np.int32)
        k[rng.rand(n) < 0.2] = INVALID_LEFT
        k[rng.rand(n) < 0.2] = INVALID_RIGHT
        k[rng.rand(n) < 0.05] = INT32_MIN
        return k
    return rng.randint(INT32_MIN, INVALID_LEFT, size=n,
                       dtype=np.int64).astype(np.int32)  # "random"


_SORT_KINDS = ["equal", "int32_min", "sentinels", "random"]


@pytest.mark.parametrize("kind", _SORT_KINDS)
@pytest.mark.parametrize("n", [1, 33, 1025])
def test_sort_ranks_edges_match_pallas_and_ref(n, kind):
    keys = _sort_keys(kind, n, np.random.RandomState(n))
    got = t_sm_ops.sort_ranks(torch.from_numpy(keys))
    kern = j_sm_ops.sort_ranks(jnp.asarray(keys), use_kernel=True,
                               interpret=True)
    _eq(got, kern)
    _eq(got, j_sm_ref.sort_ranks(jnp.asarray(keys)))
    want = np.empty(n, np.int32)
    want[np.argsort(keys, kind="stable")] = np.arange(n)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------- the card's designs, in numpy --
# Test-only emulations of the decompositions of csrc/pair_expand.cu (merge
# path) and csrc/sort_ranks.cu (row blocks with a warp reduce-scatter;
# radix passes with index payloads), at small tiles so every edge of the
# decomposition shows, held to the plain versions and the Pallas kernels.

def _clamp_slot(p, capacity):
    return min(max(int(p), 0), capacity)


def _rows_before(prefix, capacity, d):
    """The kernel's 32-way warp search for #{a : a + clamp(prefix[a]) < d};
    checks that its probes are monotone and returns (rows, rounds)."""
    n = len(prefix)
    lo, hi = min(max(0, d - capacity), n), min(d, n)
    rounds = 0
    while lo < hi:
        span = hi - lo
        probes = [lo + span * lane // 32 for lane in range(32)]
        before = [p + _clamp_slot(prefix[p], capacity) < d for p in probes]
        m = sum(before)
        assert before == [True] * m + [False] * (32 - m)
        next_lo = lo + span * (m - 1) // 32 + 1 if m else lo
        hi = lo + span * m // 32 if m < 32 else hi
        lo = next_lo
        rounds += 1
    return lo, rounds


def _merge_path_emulation(prefix, counts, capacity, threads, items, g_base):
    """Blocks of threads * items merge positions: the tail shortcut, two
    split searches, rows staged with their merge bounds, per-thread
    sub-diagonal searches and walks, and stores in a scalar head, groups
    of 4 aligned to the flat output index g_base + t, and a scalar tail.
    Every slot is written exactly once."""
    n, tile = len(prefix), threads * items
    out = np.zeros((3, capacity), np.int64)
    writes = np.zeros(capacity, np.int64)
    total = int(prefix[-1])
    last_start = total - int(counts[-1])
    max_rounds = 0

    def store(t0, count, row_of):
        g0 = g_base + t0
        head = min(count, (4 - g0 % 4) % 4)
        groups = (count - head) // 4
        order = list(range(head))
        for q in range(groups):
            assert (g0 + head + 4 * q) % 4 == 0
            order += range(head + 4 * q, head + 4 * q + 4)
        order += range(head + 4 * groups, count)
        assert sorted(order) == list(range(count))
        for u in order:
            i, off = row_of(u)
            out[:, t0 + u] = i, off, t0 + u < total
            writes[t0 + u] += 1

    for d0 in range(0, n + capacity, tile):
        d1 = min(d0 + tile, n + capacity)
        if d0 >= n + _clamp_slot(total, capacity):  # wholly past the total
            t0 = d0 - n
            store(t0, d1 - d0, lambda u, t0=t0: (n - 1, t0 + u - last_start))
            continue
        (a0, r0), (a1, r1) = (_rows_before(prefix, capacity, d)
                              for d in (d0, d1))
        max_rounds = max(max_rounds, r0, r1)
        t0, na = d0 - a0, a1 - a0
        nt = d1 - a1 - t0
        assert na >= 0 and nt >= 0 and na + nt == d1 - d0
        if nt == 0:  # rows only: the block writes nothing
            continue
        bound = [_clamp_slot(prefix[a], capacity) - t0 if a < n else None
                 for a in range(a0, a1 + 1)]
        start = [int(prefix[a]) - int(counts[a]) if a < n else last_start
                 for a in range(a0, a1 + 1)]
        row = [None] * nt
        for th in range(threads):
            r = th * items
            if r >= d1 - d0:
                continue
            lo, hi = max(0, r - nt), min(r, na)
            while lo < hi:
                mid = (lo + hi) // 2
                if bound[mid] < r - mid:
                    lo = mid + 1
                else:
                    hi = mid
            k, u = lo, r - lo
            for _ in range(r, min(r + items, d1 - d0)):
                if k < na and bound[k] <= u:
                    k += 1
                else:
                    assert row[u] is None
                    row[u] = k
                    u += 1
        assert None not in row
        store(t0, nt, lambda u, a0=a0, t0=t0, row=row, start=start: (
            min(a0 + row[u], n - 1), t0 + u - start[row[u]]))
    np.testing.assert_array_equal(writes, 1)
    return out, max_rounds


@pytest.mark.parametrize("g_base", [0, 1, 3])
@pytest.mark.parametrize("threads,items", [(1, 1), (4, 2), (8, 4), (32, 8),
                                           (128, 16)])
@pytest.mark.parametrize("case", _EXPAND_CASES)
def test_merge_path_design_matches_pallas_and_plain(case, threads, items,
                                                    g_base):
    rng = np.random.RandomState(len(case) + threads)
    counts, capacity = _expand_case(case, rng)
    counts = counts.astype(np.int32)
    prefix = np.cumsum(counts).astype(np.int32)
    got, rounds = _merge_path_emulation(prefix, counts, capacity, threads,
                                        items, g_base)
    plain = t_pe_ops.pair_expand(
        torch.from_numpy(prefix), torch.from_numpy(counts), capacity
    )
    kern = j_pe_ops.pair_expand(
        jnp.asarray(prefix), jnp.asarray(counts), capacity,
        use_kernel=True, interpret=True,
    )
    for e, p, k in zip(got, plain, kern):
        np.testing.assert_array_equal(e, p.numpy().astype(np.int64))
        np.testing.assert_array_equal(e, np.asarray(k).astype(np.int64))
    assert rounds <= 4  # 32-way rounds for up to 2^15 candidate rows


def test_merge_path_search_rounds_at_the_engine_bucket():
    """The warp search over 2^20 rows takes at most 5 rounds of 32 probes
    (the binary search it replaces: 21 dependent loads)."""
    rng = np.random.RandomState(1)
    prefix = np.cumsum(rng.randint(0, 7, size=1 << 20)).astype(np.int64)
    capacity = 1 << 22
    for d in rng.randint(0, (1 << 20) + capacity, size=50).tolist():
        rows, rounds = _rows_before(prefix, capacity, d)
        pos = np.arange(len(prefix)) + np.clip(prefix, 0, capacity)
        assert rows == int(np.count_nonzero(pos < d))
        assert rounds <= 5


def _slot_search_emulation(prefix, counts, capacity, block):
    """The search path of pair_expand.cu over a stack of lanes (lanes, n):
    a thread per (lane, slot) in blocks of `block` threads, each slot's
    binary search of its lane's prefix as the kernel's loop codes it, at
    the flat offsets the kernel computes."""
    lanes, n_left = prefix.shape
    flat_p, flat_c = prefix.ravel(), counts.ravel()
    out = [np.full(lanes * capacity, -1, np.int64) for _ in range(3)]
    for y in range(lanes):
        base = y * n_left
        for bx in range(-(-capacity // block)):
            for tx in range(block):
                t = bx * block + tx
                if t >= capacity:
                    continue
                lo, hi = 0, n_left
                while lo < hi:
                    mid = (lo + hi) >> 1
                    if flat_p[base + mid] <= t:
                        lo = mid + 1
                    else:
                        hi = mid
                i = min(lo, n_left - 1)
                o = y * capacity + t
                out[0][o] = i
                out[1][o] = t - (flat_p[base + i] - flat_c[base + i])
                out[2][o] = t < flat_p[base + n_left - 1]
    return [x.reshape(lanes, capacity) for x in out]


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("case", _EXPAND_CASES)
def test_slot_search_design_matches_pallas_and_plain(case, lanes):
    """The search path (launches of up to 2^18 slots): every lane equals
    the plain version and the Pallas kernel; the other lanes permute the
    first one's counts, so they share its capacity."""
    rng = np.random.RandomState(len(case) + lanes)
    counts, capacity = _expand_case(case, rng)
    counts = np.stack([counts] + [rng.permutation(counts)
                                  for _ in range(lanes - 1)]).astype(np.int32)
    prefix = np.cumsum(counts, axis=1).astype(np.int32)
    got = _slot_search_emulation(prefix, counts, capacity, 256)
    for w in range(lanes):
        plain = t_pe_ops.pair_expand(torch.from_numpy(prefix[w]),
                                     torch.from_numpy(counts[w]), capacity)
        kern = j_pe_ops.pair_expand(
            jnp.asarray(prefix[w]), jnp.asarray(counts[w]), capacity,
            use_kernel=True, interpret=True,
        )
        for e, p, k in zip(got, plain, kern):
            np.testing.assert_array_equal(e[w], p.numpy().astype(np.int64))
            np.testing.assert_array_equal(e[w], np.asarray(k).astype(np.int64))


def _rank_compare_emulation(keys, threads):
    """Blocks of 32 rows: each thread counts the keys j = t, t + threads,
    ... before the block's rows (<=), the block's own keys (< or an equal
    key at a lower index) and the keys after them (<); each warp's 32
    per-row counts meet in lane r by the reduce-scatter of shuffles
    (distance s = 16 .. 1), then the warps' sums in shared memory."""
    n = len(keys)
    rank = np.full(n, -1, np.int64)
    for base in range(0, n, 32):
        rows = min(32, n - base)
        key = np.zeros(32, np.int64)
        key[:rows] = keys[base:base + rows]
        acc = np.zeros((threads, 32), np.int64)
        for t in range(threads):
            before = keys[t:base:threads].astype(np.int64)
            acc[t] += (before[:, None] <= key[None, :]).sum(0)
            if t < rows:
                v = int(keys[base + t])
                acc[t] += (v < key) | ((v == key) & (t < np.arange(32)))
            after = keys[base + rows + t::threads].astype(np.int64)
            acc[t] += (after[:, None] < key[None, :]).sum(0)
        part = []
        for w in range(threads // 32):
            a = acc[32 * w:32 * w + 32].copy()  # a[lane, k]
            s = 16
            while s >= 1:
                nxt = a.copy()
                for lane in range(32):
                    partner = lane ^ s
                    upper, p_upper = lane & s, partner & s
                    for k in range(s):
                        recv = a[partner, k] if p_upper else a[partner, k + s]
                        keep = a[lane, k + s] if upper else a[lane, k]
                        nxt[lane, k] = keep + recv
                a = nxt
                s //= 2
            part.append(a[:, 0])
        rank[base:base + rows] = np.sum(part, axis=0)[:rows]
    return rank.astype(np.int32)


@pytest.mark.parametrize("kind", _SORT_KINDS)
@pytest.mark.parametrize("n,threads", [(1, 32), (31, 32), (32, 64),
                                       (33, 32), (100, 64), (300, 256)])
def test_rank_compare_design_matches_pallas_and_plain(n, threads, kind):
    keys = _sort_keys(kind, n, np.random.RandomState(n + threads))
    got = _rank_compare_emulation(keys, threads)
    np.testing.assert_array_equal(
        got, t_sm_ops.sort_ranks(torch.from_numpy(keys)).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(j_sm_ops.sort_ranks(jnp.asarray(keys), use_kernel=True,
                                            interpret=True)))


@pytest.mark.parametrize("kind", _SORT_KINDS)
@pytest.mark.parametrize("n,warps,items", [(1, 1, 1), (65, 1, 2),
                                           (700, 2, 2)])
def test_rank_radix_design_matches_pallas_and_plain(n, warps, items, kind):
    """The radix path: the first pass takes each key's index as its
    payload, and the last writes rank[payload] = the key's position; the
    passes between are the pair sort's (emulated in
    test_torch_sort_segment.py)."""
    from test_torch_sort_segment import _radix_sort_emulation

    keys = _sort_keys(kind, n, np.random.RandomState(n + warps))
    _, index = _radix_sort_emulation(keys, np.arange(n, dtype=np.int32),
                                     warps, items)
    got = np.full(n, -1, np.int32)
    got[index] = np.arange(n)
    np.testing.assert_array_equal(
        got, t_sm_ops.sort_ranks(torch.from_numpy(keys)).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(j_sm_ops.sort_ranks(jnp.asarray(keys), use_kernel=True,
                                            interpret=True)))


# ----------------------------------------------------- kernel library names --
def test_library_name_changes_when_an_included_header_changes(tmp_path,
                                                              monkeypatch):
    """A source's library name hashes the shared headers (every header in
    the include folder), so an edited header is rebuilt, never loaded
    stale. No nvcc needed."""
    from repro_torch import kernels

    csrc = tmp_path / "pkg" / "csrc"
    include = tmp_path / "include"
    csrc.mkdir(parents=True)
    include.mkdir()
    (csrc / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\n')
    (include / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (include / "b.cuh").write_text("// b\n")
    monkeypatch.setattr(kernels, "KERNELS_DIR", tmp_path)
    monkeypatch.setattr(kernels, "INCLUDE_DIR", include)
    names = [kernels.library_path("pkg", "k")]
    (include / "b.cuh").write_text("// b, edited\n")
    names.append(kernels.library_path("pkg", "k"))
    (include / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n\n')
    names.append(kernels.library_path("pkg", "k"))
    (include / "c.cuh").write_text("// a new header\n")
    names.append(kernels.library_path("pkg", "k"))
    assert len(set(names)) == 4
    assert kernels.library_path("pkg", "k") == names[-1]  # stable


def test_radix_sources_include_the_shared_header():
    from repro_torch import kernels

    header = kernels.INCLUDE_DIR / "radix_sort.cuh"
    assert header.is_file()
    for package, stem in (("bitonic_sort", "bitonic_sort"),
                          ("spmm_join", "sort_ranks"),
                          ("spmm_join", "match_layout")):
        text = kernels.source(package, stem).read_text()
        assert '#include "radix_sort.cuh"' in text
    # the compare paths' warp reduce-scatter lives in one header
    assert (kernels.INCLUDE_DIR / "compare_fold.cuh").is_file()
    for stem in ("sort_ranks", "match_layout"):
        text = kernels.source("spmm_join", stem).read_text()
        assert '#include "compare_fold.cuh"' in text
        assert "void fold(" not in text
