"""The port's pair sort and sorted segment sum on the CPU (their plain
versions) against the JAX ops on their Pallas kernels in interpret mode and
the jnp references, at the shapes of the reference's kernel tests. The sort
is unstable on the card, so sorts are held on their keys and on their
(key, payload) multisets; segment sums are held to the reference test's
tolerances."""
import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitonic_sort import ops as j_sort_ops
from repro.kernels.segment_reduce import ops as j_seg_ops
from repro.kernels.segment_reduce import ref as j_seg_ref
from repro_torch.kernels.bitonic_sort import ops as t_sort_ops
from repro_torch.kernels.segment_reduce import ops as t_seg_ops

INT32_MAX = 2**31 - 1


def _pairs(keys, vals) -> list[tuple[int, int]]:
    return sorted(zip(np.asarray(keys).tolist(), np.asarray(vals).tolist()))


# ------------------------------------------------------------- pair sort --
@pytest.mark.parametrize("n", [1, 2, 7, 16, 100, 255, 256, 1000, 4096])
def test_sort_pairs_matches_pallas(n):
    rng = np.random.RandomState(n)
    keys = rng.randint(0, max(2, n // 2), size=n).astype(np.int32)  # dups
    vals = rng.randint(-(2**31), INT32_MAX, size=n).astype(np.int32)
    sk, sv = t_sort_ops.sort_pairs(torch.from_numpy(keys), torch.from_numpy(vals))
    jk, jv = j_sort_ops.sort_pairs(
        jnp.asarray(keys), jnp.asarray(vals), use_kernel=True, interpret=True
    )
    assert sk.dtype == torch.int32 and sv.dtype == torch.int32
    np.testing.assert_array_equal(sk.numpy(), np.asarray(jk))
    assert _pairs(sk, sv) == _pairs(jk, jv) == _pairs(keys, vals)


@pytest.mark.parametrize("seed", range(6))
def test_sort_pairs_random_lengths_and_signs(seed):
    """The reference's property test, as a deterministic sweep."""
    rng = np.random.RandomState(100 + seed)
    xs = rng.randint(-(2**20), 2**20, size=rng.randint(1, 300)).astype(np.int32)
    sk, _ = t_sort_ops.sort_pairs(torch.from_numpy(xs), torch.zeros(len(xs), dtype=torch.int32))
    jk, _ = j_sort_ops.sort_pairs(jnp.asarray(xs), jnp.zeros(len(xs), jnp.int32),
                                  use_kernel=True, interpret=True)
    np.testing.assert_array_equal(sk.numpy(), np.sort(xs))
    np.testing.assert_array_equal(sk.numpy(), np.asarray(jk))


def test_argsort_matches_pallas_and_is_a_permutation():
    keys = np.random.RandomState(0).randint(-50, 50, 513).astype(np.int32)
    got = t_sort_ops.argsort_i32(torch.from_numpy(keys))
    want = j_sort_ops.argsort_i32(jnp.asarray(keys), use_kernel=True, interpret=True)
    assert got.dtype == torch.int32
    assert sorted(got.tolist()) == list(range(513))
    np.testing.assert_array_equal(keys[got.numpy()], np.sort(keys))
    np.testing.assert_array_equal(keys[got.numpy()], keys[np.asarray(want)])


def test_sort_pairs_keeps_payloads_of_int32_max_keys():
    """A real INT32_MAX key keeps its own payload. (The reference pads to
    a power of two with INT32_MAX keys and zero payloads, so its kernel
    path may return a pad's zero in place of such a payload.)"""
    keys = np.array([5, INT32_MAX, -3, INT32_MAX, 0], np.int32)
    vals = np.array([10, 11, 12, 13, 14], np.int32)
    sk, sv = t_sort_ops.sort_pairs(torch.from_numpy(keys), torch.from_numpy(vals))
    np.testing.assert_array_equal(sk.numpy(), np.sort(keys))
    assert _pairs(sk, sv) == _pairs(keys, vals)


# --------------------------------------------------------- segment sum --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,s", [(10, 8, 4), (512, 128, 16), (1000, 64, 33)])
def test_segment_sum_matches_pallas(n, d, s, dtype):
    rng = np.random.RandomState(n + d)
    ids = np.sort(rng.randint(0, s, size=n)).astype(np.int32)
    data = rng.randn(n, d).astype(np.float32)
    t_dtype, j_dtype = getattr(torch, dtype), getattr(jnp, dtype)
    got = t_seg_ops.sorted_segment_sum(
        torch.from_numpy(data).to(t_dtype), torch.from_numpy(ids), s
    )
    assert got.dtype == t_dtype and got.shape == (s, d)
    kern = j_seg_ops.sorted_segment_sum(
        jnp.asarray(data, j_dtype), jnp.asarray(ids), s,
        use_kernel=True, interpret=True,
    )
    # both against the float32 ground truth, at the reference test's
    # tolerances (both accumulate in float32, then round to the type)
    want = np.asarray(j_seg_ref.sorted_segment_sum(jnp.asarray(data), jnp.asarray(ids), s))
    rtol, atol = (1e-6, 1e-5) if dtype == "float32" else (5e-2, 0.3)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=atol)
    np.testing.assert_allclose(
        np.asarray(kern, np.float32), want, rtol=rtol, atol=atol
    )


@pytest.mark.parametrize("seed", range(5))
def test_segment_sum_random_shapes_match_pallas(seed):
    """The reference's property test, as a deterministic sweep."""
    rng = np.random.RandomState(7 * seed + 1)
    n, d, s = rng.randint(1, 200), rng.randint(1, 17), rng.randint(1, 40)
    ids = np.sort(rng.randint(0, s, size=n)).astype(np.int32)
    data = rng.randn(n, d).astype(np.float32)
    got = t_seg_ops.sorted_segment_sum(torch.from_numpy(data), torch.from_numpy(ids), s)
    want = j_seg_ops.sorted_segment_sum(jnp.asarray(data), jnp.asarray(ids), s,
                                        use_kernel=True, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_segment_sum_empty_segments_are_zero():
    out = t_seg_ops.sorted_segment_sum(
        torch.ones(4, 3), torch.tensor([0, 0, 3, 3], dtype=torch.int32), 5
    )
    np.testing.assert_allclose(out[1].numpy(), 0.0)
    np.testing.assert_allclose(out[4].numpy(), 0.0)
    np.testing.assert_allclose(out[0].numpy(), 2.0)


@pytest.mark.parametrize("s", [6, 5000])
def test_segment_sum_drops_out_of_range_ids_like_jax(s):
    """Negative ids and ids >= num_segments are dropped, as
    jax.ops.segment_sum drops them — also above the reference's 4096-segment
    kernel limit, where its op routes to the jnp reference."""
    rng = np.random.RandomState(s)
    ids = np.sort(rng.randint(-3, s + 3, size=700)).astype(np.int32)
    data = rng.randn(700, 9).astype(np.float32)
    got = t_seg_ops.sorted_segment_sum(torch.from_numpy(data), torch.from_numpy(ids), s)
    want = j_seg_ops.sorted_segment_sum(jnp.asarray(data), jnp.asarray(ids), s,
                                        use_kernel=True, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


# ------------------------------------------- the card's designs, in numpy --
# Test-only emulations of the two CUDA kernels' decompositions
# (csrc/bitonic_sort.cu's radix passes, csrc/segment_sum.cu's chunks,
# carry and finishing launch), run at small tiles and chunks so that every
# edge case of the decomposition shows, and held to the JAX ops and to the
# port's plain versions.

def _radix_sort_emulation(keys, vals, warps, items):
    """Four LSD passes of 8-bit digits of k ^ 0x80000000: per-tile digit
    counts, an exclusive scan over the (digit, tile)-major counts, and a
    stable scatter whose ranks come as the kernel's do (warp w ranks its
    slice of the tile 32 keys at a time, lane order inside a step)."""
    tile = warps * items * 32
    n = len(keys)
    tiles = -(-n // tile)
    k, v = keys.astype(np.int32), vals.astype(np.int32)
    for shift in (0, 8, 16, 24):
        digit = ((k.view(np.uint32) ^ np.uint32(0x80000000)) >> shift) & 255
        counts = np.zeros((256, tiles), np.int64)
        for t in range(tiles):
            counts[:, t] = np.bincount(digit[t * tile:(t + 1) * tile],
                                       minlength=256)
        # the scan launch: per digit, over its tiles, and the digit totals;
        # with the scatter's scan of the totals it is the exclusive scan of
        # the (digit, tile)-major counts
        offsets = np.cumsum(counts, 1) - counts
        totals = counts.sum(1)
        digit_start = np.cumsum(totals) - totals
        flat = counts.reshape(-1)
        np.testing.assert_array_equal(
            (np.cumsum(flat) - flat).reshape(256, tiles),
            offsets + digit_start[:, None])
        out_k = np.empty_like(k)
        out_v = np.empty_like(v)
        for t in range(tiles):
            base = t * tile
            valid = min(tile, n - base)
            warp_digit = np.zeros((warps, 256), np.int64)
            rank = np.zeros(valid, np.int64)
            for w in range(warps):
                for it in range(items):
                    p = w * items * 32 + it * 32 + np.arange(32)
                    p = p[p < valid]
                    dg = digit[base + p]
                    for lane, pos in enumerate(p):  # peers below the lane
                        rank[pos] = (warp_digit[w, dg[lane]]
                                     + np.count_nonzero(dg[:lane] == dg[lane]))
                    np.add.at(warp_digit[w], dg, 1)
            tile_counts = warp_digit.sum(0)
            tile_start = np.cumsum(tile_counts) - tile_counts
            warp_start = np.cumsum(warp_digit, 0) - warp_digit + tile_start
            for pos in range(valid):
                dg = digit[base + pos]
                w = pos // (items * 32)
                in_tile = warp_start[w, dg] + rank[pos]
                dst = digit_start[dg] + offsets[dg, t] + in_tile - tile_start[dg]
                out_k[dst] = k[base + pos]
                out_v[dst] = v[base + pos]
        k, v = out_k, out_v
    return k, v


_KEY_KINDS = ["random", "duplicates", "equal", "extremes", "reversed"]


def _keys_of(kind, n, rng):
    if kind == "random":
        return rng.randint(-(2**31), INT32_MAX, size=n, dtype=np.int64).astype(np.int32)
    if kind == "duplicates":
        return rng.randint(-5, 5, size=n).astype(np.int32)
    if kind == "equal":
        return np.full(n, 42, np.int32)
    if kind == "extremes":
        return rng.choice(np.array([-(2**31), -1, 0, INT32_MAX], np.int32), size=n)
    return np.arange(n, 0, -1).astype(np.int32) * 1000


@pytest.mark.parametrize("kind", _KEY_KINDS)
@pytest.mark.parametrize("n,warps,items", [(1, 1, 1), (31, 1, 1), (64, 1, 2),
                                           (65, 1, 2), (700, 2, 2),
                                           (1000, 4, 1)])
def test_radix_sort_design_matches_pallas_and_plain(n, warps, items, kind):
    rng = np.random.RandomState(n + warps)
    keys = _keys_of(kind, n, rng)
    vals = rng.randint(-(2**31), INT32_MAX, size=n, dtype=np.int64).astype(np.int32)
    ek, ev = _radix_sort_emulation(keys, vals, warps, items)
    pk, pv = t_sort_ops.sort_pairs(torch.from_numpy(keys), torch.from_numpy(vals))
    jk, jv = j_sort_ops.sort_pairs(jnp.asarray(keys), jnp.asarray(vals),
                                   use_kernel=True, interpret=True)
    # stable: keys and payloads equal the plain version's bit for bit
    np.testing.assert_array_equal(ek, pk.numpy())
    np.testing.assert_array_equal(ev, pv.numpy())
    # the JAX kernel is unstable: keys, and the (key, payload) multiset
    np.testing.assert_array_equal(ek, np.asarray(jk))
    if kind != "extremes":  # the reference's INT32_MAX pads (ROADMAP Queue 3)
        assert _pairs(ek, ev) == _pairs(jk, jv)


class _Kahan:
    """A compensated float32 sum, as the kernel keeps one per column."""

    def __init__(self, d):
        self.acc = np.zeros(d, np.float32)
        self.err = np.zeros(d, np.float32)

    def add(self, x):
        y = (x - self.err).astype(np.float32)
        t = (self.acc + y).astype(np.float32)
        self.err = ((t - self.acc) - y).astype(np.float32)
        self.acc = t

    def total(self):
        return (self.acc - self.err).astype(np.float32)


def _segment_sum_emulation(data, ids, num_segments, chunk, lanes):
    """The chunk / carry / finish decomposition in float32: a chunk sums
    each segment in row order (compensated), writes those it holds whole,
    zero-fills the id gaps it sees and leaves partials of the crossing ones
    in carry slot 0 (from the chunk before) or 1 (into the next); then the
    first chunk of each crossing segment adds its partials, lane l taking
    l, l + lanes, ... in order, then the lanes in order. Every output row
    is written exactly once."""
    n, d = data.shape
    chunks = max(1, -(-n // chunk))
    out = np.zeros((num_segments, d), np.float32)
    writes = np.zeros(num_segments, np.int64)
    carry = np.full((chunks, 2, d), np.nan, np.float32)

    def write(lo, hi, value):
        lo, hi = max(lo, 0), min(hi, num_segments)
        if lo < hi:
            out[lo:hi] = value
            writes[lo:hi] += 1

    for c in range(chunks):
        r0, r1 = c * chunk, min(n, (c + 1) * chunk)
        if r0 == 0:
            write(0, int(ids[0]) if n else num_segments, 0.0)
        acc = _Kahan(d)
        seg_start = r0
        for r in range(r0, r1):
            acc.add(data[r])
            sid = int(ids[r])
            ends = r + 1 == n or ids[r + 1] != sid
            if not ends and r + 1 < r1:
                continue
            if 0 <= sid < num_segments:
                if seg_start == r0 and r0 > 0 and ids[r0 - 1] == sid:
                    carry[c, 0] = acc.total()
                elif not ends:
                    carry[c, 1] = acc.total()
                else:
                    write(sid, sid + 1, acc.total())
            if ends:
                write(sid + 1, num_segments if r + 1 == n else int(ids[r + 1]), 0.0)
            acc = _Kahan(d)
            seg_start = r + 1
    for c in range(chunks):
        r1 = (c + 1) * chunk
        if r1 >= n:
            continue
        sid = int(ids[r1 - 1])
        if ids[r1] != sid or not 0 <= sid < num_segments:
            continue
        if c > 0 and ids[c * chunk - 1] == sid:
            continue
        last = max(k for k in range(c + 1, chunks) if ids[k * chunk] == sid)
        parts = [carry[c, 1]] + [carry[k, 0] for k in range(c + 1, last + 1)]
        lane_sums = []
        for lane in range(lanes):
            acc = _Kahan(d)
            for p in parts[lane::lanes]:
                acc.add(p)
            lane_sums.append(acc.total())
        acc = _Kahan(d)
        for lane_sum in lane_sums:
            acc.add(lane_sum)
        assert not np.isnan(acc.total()).any()
        write(sid, sid + 1, acc.total())
    np.testing.assert_array_equal(writes, 1)
    return out


def _segment_case(case, rng):
    if case == "uniform":
        n, d, s = 700, 5, 40
        ids = rng.randint(-3, s + 3, size=n)
    elif case == "skew":  # segment 7 holds half the rows
        n, d, s = 800, 3, 50
        ids = np.concatenate([rng.randint(0, s, size=n // 2), np.full(n // 2, 7)])
    elif case == "gaps":  # empty segments below, between and above
        n, d, s = 500, 4, 300
        ids = rng.randint(0, 25, size=n) * 11 + 9
    else:  # one segment, every row
        n, d, s = 300, 2, 6
        ids = np.full(n, 4)
    ids = np.sort(ids).astype(np.int32)
    return rng.randn(n, d).astype(np.float32), ids, s


@pytest.mark.parametrize("lanes", [1, 3, 8])
@pytest.mark.parametrize("chunk", [1, 2, 5, 8, 64])
@pytest.mark.parametrize("case", ["uniform", "skew", "gaps", "one_segment"])
def test_segment_sum_design_matches_pallas_and_plain(case, chunk, lanes):
    rng = np.random.RandomState(chunk * 10 + lanes)
    data, ids, s = _segment_case(case, rng)
    got = _segment_sum_emulation(data, ids, s, chunk, lanes)
    plain = t_seg_ops.sorted_segment_sum(torch.from_numpy(data), torch.from_numpy(ids), s)
    jax_k = j_seg_ops.sorted_segment_sum(jnp.asarray(data), jnp.asarray(ids), s,
                                         use_kernel=True, interpret=True)
    np.testing.assert_allclose(got, plain.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jax_k), rtol=1e-5, atol=1e-4)


def test_compensated_chunked_sum_of_a_long_segment_is_near_exact():
    """The kernel's order over one segment of 2^16 rows (chunks of 512,
    compensated, 8 lanes) stays within a few float32 roundings of the
    float64 sum (rtol 1e-7, atol 1e-3); a plain sequential float32 sum of
    the same rows does not."""
    rng = np.random.RandomState(5)
    n, d = 1 << 16, 4
    data = (rng.randn(n, d) + 0.5).astype(np.float32)
    ids = np.full(n, 0, np.int32)
    exact = data.astype(np.float64).sum(0)
    got = _segment_sum_emulation(data, ids, 1, 512, 8)[0]
    np.testing.assert_allclose(got, exact, rtol=1e-7, atol=1e-3)
    sequential = np.cumsum(data, 0, dtype=np.float32)[-1]
    assert (np.abs(sequential - exact) > 1e-3 + 1e-7 * np.abs(exact)).any()


def test_segment_sum_design_with_no_rows_zero_fills():
    got = _segment_sum_emulation(np.zeros((0, 3), np.float32),
                                 np.zeros(0, np.int32), 4, 8, 2)
    np.testing.assert_array_equal(got, 0.0)


def test_plain_segment_sum_takes_float64_in_float64():
    """The card checks hold float32 sums to the plain version in float64,
    the exact sum: its rows stay float64 and equal numpy's float64 sums."""
    rng = np.random.RandomState(3)
    ids = np.sort(rng.randint(0, 5, 50)).astype(np.int32)
    data = rng.randn(50, 3)
    got = t_seg_ops.sorted_segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 5)
    assert got.dtype == torch.float64
    want = np.stack([data[ids == i].sum(0) for i in range(5)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
