"""Card-only tests of the port: the CUDA kernels against their plain
versions, and the engine on the card against the engine on the CPU.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card every test here skips (the check is made in the `cuda`
fixture, so every pytest worker collects the same tests)."""
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.bitonic_sort import kernel as sort_kernel
from repro_torch.kernels.bitonic_sort import ops as sort_ops
from repro_torch.kernels.bitonic_sort import ref as sort_ref
from repro_torch.kernels.pair_expand import kernel as pe_kernel
from repro_torch.kernels.pair_expand import ops as pe_ops
from repro_torch.kernels.pair_expand import ref as pe_ref
from repro_torch.kernels.spmm_join import kernel as sm_kernel
from repro_torch.kernels.spmm_join import ops as sm_ops
from repro_torch.kernels.segment_reduce import kernel as seg_kernel
from repro_torch.kernels.segment_reduce import ops as seg_ops
from repro_torch.kernels.segment_reduce import ref as seg_ref
from repro_torch.kernels.spmm_join import ref as sm_ref

pytestmark = pytest.mark.gpu

INVALID_LEFT = 2**31 - 1
INVALID_RIGHT = 2**31 - 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _keys(gen, n, hi, sentinel, device):
    k = torch.randint(0, hi, (n,), generator=gen, dtype=torch.int32)
    k[torch.rand(n, generator=gen) < 0.15] = sentinel
    return k.to(device)


def _equal(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize(
    "n_left,capacity", [(1, 1), (1, 1000), (2, 7), (700, 1500), (1 << 16, 1 << 18),
                        (1 << 16, (1 << 18) + 1), (5, 1 << 19)]
)
def test_pair_expand_kernel_equals_plain(cuda, n_left, capacity):
    """Both paths: the search up to 2^18 slots, the merge path above."""
    assert pe_kernel.search_at(1, capacity) == (capacity <= 1 << 18)
    gen = torch.Generator().manual_seed(n_left)
    counts = torch.randint(0, 5, (n_left,), generator=gen, dtype=torch.int32)
    prefix = torch.cumsum(counts, 0, dtype=torch.int32)
    before = kernels.LAUNCHES["pair_expand"]
    got = pe_ops.pair_expand(prefix.to(cuda), counts.to(cuda), capacity)
    assert kernels.LAUNCHES["pair_expand"] == before + 1
    _equal(got, pe_ref.pair_expand(prefix.to(cuda), counts.to(cuda), capacity))


@pytest.mark.parametrize(
    "n_l,n_r", [(1, 1), (1, 5), (4, 1), (130, 70), (1100, 300), (5000, 64),
                (4096, 1024)]
)
def test_match_layout_kernel_equals_plain(cuda, n_l, n_r):
    gen = torch.Generator().manual_seed(n_l * 7 + n_r)
    lk = _keys(gen, n_l, 11, INVALID_LEFT, cuda)
    rk = _keys(gen, n_r, 11, INVALID_RIGHT, cuda)
    before = kernels.LAUNCHES["match_layout"]
    got = sm_ops.match_layout(lk, rk)
    assert kernels.LAUNCHES["match_layout"] == before + 1
    _equal(got, sm_ref.match_layout(lk, rk))


@pytest.mark.parametrize("n", [1, 2, 17, 1300, 4096, 5000])
def test_sort_ranks_kernel_equals_plain(cuda, n):
    gen = torch.Generator().manual_seed(n)
    keys = _keys(gen, n, max(2, n // 3), INVALID_RIGHT, cuda)
    before = kernels.LAUNCHES["sort_ranks"]
    got = sm_ops.sort_ranks(keys)
    assert kernels.LAUNCHES["sort_ranks"] == before + 1
    _equal([got], [sm_ref.sort_ranks(keys)])


def _expand_inputs(case, gen, path, lanes=None):
    """(prefix, counts, capacity) of one edge case: for the merge path
    (its tiles hold 2048 merge positions, rows and slots together) 50,000
    rows and more than 2^18 slots, for the search path 1,000 rows and at
    most 2^18 slots over 8 lanes."""
    rows = 50_000 if path == "merge" else 1_000
    shape = (lanes, rows) if lanes else (rows,)
    counts = torch.randint(1, 7, shape, generator=gen, dtype=torch.int32)
    if case == "zero_runs":  # 90% zero counts, one run of 2/5 of the rows
        counts *= torch.rand(shape, generator=gen) < 0.1
        counts[..., rows // 5:3 * rows // 5] = 0
    elif case == "one_group":  # one row holds 9,000 slots
        counts.zero_()
        counts[..., 777] = 9000
    elif case == "all_zero":
        counts.zero_()
    elif case == "few_slots":  # a dozen matches among the left rows
        counts *= torch.rand(shape, generator=gen) < 12 / rows
    total = int(counts.sum(-1).max())
    capacity = {"total_third": 3 * total, "over_capacity": total // 2 + 3,
                "all_zero": 4099, "few_slots": 64}.get(case, total + 5)
    if path == "merge":  # past the search path's 2^18 slots
        capacity = max(capacity, (1 << 18) + 3)
    prefix = torch.cumsum(counts, -1, dtype=torch.int32)
    return prefix, counts, capacity


_EXPAND_EDGES = ["uniform", "zero_runs", "total_third", "over_capacity",
                 "one_group", "all_zero", "few_slots"]


@pytest.mark.parametrize("path", ["merge", "search"])
@pytest.mark.parametrize("case", _EXPAND_EDGES)
def test_pair_expand_edges_equal_plain(cuda, case, path):
    prefix, counts, capacity = _expand_inputs(
        case, torch.Generator().manual_seed(len(case)), path)
    assert pe_kernel.search_at(1, capacity) == (path == "search")
    prefix, counts = prefix.to(cuda), counts.to(cuda)
    before = kernels.LAUNCHES["pair_expand"]
    got = pe_ops.pair_expand(prefix, counts, capacity)
    assert kernels.LAUNCHES["pair_expand"] == before + 1
    _equal(got, pe_ref.pair_expand(prefix, counts, capacity))


@pytest.mark.parametrize("path", ["merge", "search"])
@pytest.mark.parametrize("lanes", [1, 3, 8])
@pytest.mark.parametrize("case", ["zero_runs", "total_third", "over_capacity"])
def test_stacked_pair_expand_edges_equal_single_calls(cuda, case, lanes, path):
    """Lane rows of slots that start off a 16-byte boundary (the capacity
    is odd): the stores' scalar edges. The path is chosen by every lane's
    slots together, so each lane also equals its single call."""
    prefix, counts, capacity = _expand_inputs(
        case, torch.Generator().manual_seed(lanes), path, lanes)
    capacity |= 1
    assert pe_kernel.search_at(lanes, capacity) == (path == "search")
    prefix, counts = prefix.to(cuda), counts.to(cuda)
    got = pe_kernel.pair_expand_cuda(prefix, counts, capacity)
    for w in range(lanes):
        want = pe_ref.pair_expand(prefix[w], counts[w], capacity)
        _equal([g[w] for g in got], want)
        _equal(pe_kernel.pair_expand_cuda(prefix[w].contiguous(),
                                          counts[w].contiguous(), capacity),
               want)


def _rank_keys(kind, shape, gen):
    if kind == "equal":
        return torch.full(shape, 5, dtype=torch.int32)
    k = torch.randint(-3, 3, shape, generator=gen, dtype=torch.int32)
    k[torch.rand(shape, generator=gen) < 0.2] = -(2**31)
    if kind == "sentinels":
        k[torch.rand(shape, generator=gen) < 0.2] = INVALID_LEFT
        k[torch.rand(shape, generator=gen) < 0.2] = INVALID_RIGHT
    return k


def _inverse_of_stable_argsort(rank, keys):
    perm = torch.argsort(keys, dim=-1, stable=True)
    want = torch.empty_like(rank).scatter_(
        -1, perm, torch.arange(keys.shape[-1], dtype=torch.int32,
                               device=keys.device).expand_as(rank).contiguous())
    return torch.equal(rank, want)


@pytest.mark.parametrize("kind", ["equal", "int32_min", "sentinels"])
@pytest.mark.parametrize("n", [1, 33, 4096, 20480, 20481, 70001, 1 << 18])
def test_sort_ranks_edges(cuda, n, kind):
    """Heavy ties, INT32_MIN and both sentinels on each side of the
    threshold: the compare path up to 20,480 keys (1 device launch), the
    radix path above (12). Bit for bit against the plain version where its
    quadratic blocks are quick, and the inverse of the stable argsort."""
    keys = _rank_keys(kind, (n,), torch.Generator().manual_seed(n)).to(cuda)
    radix = sm_kernel.radix_at(n)
    assert radix == (n > 20480)
    before = kernels.DEVICE_LAUNCHES["sort_ranks"]
    got = sm_ops.sort_ranks(keys)
    assert kernels.DEVICE_LAUNCHES["sort_ranks"] - before == (12 if radix else 1)
    if n <= 20481:
        _equal([got], [sm_ref.sort_ranks(keys)])
    assert _inverse_of_stable_argsort(got, keys)


@pytest.mark.parametrize(("path", "n"), [
    ("compare", 1), ("compare", 31), ("compare", 1000), ("compare", 5003),
    ("radix", 20481), ("radix", 20483), ("radix", 24576), ("radix", 30001)])
@pytest.mark.parametrize("lanes", [1, 3, 8])
def test_sort_ranks_paths_and_lanes_equal_plain(cuda, n, lanes, path):
    """Each path at sizes on its side of the threshold, stacked and
    single: each lane equals the plain version; odd n leaves lane rows
    off a 16-byte boundary."""
    assert sm_kernel.radix_at(n) == (path == "radix")
    keys = _rank_keys("sentinels", (lanes, n),
                      torch.Generator().manual_seed(n + lanes)).to(cuda)
    got = sm_kernel.sort_ranks_cuda(keys)
    for w in range(lanes):
        want = sm_ref.sort_ranks(keys[w])
        _equal([got[w]], [want])
        _equal([sm_kernel.sort_ranks_cuda(keys[w].contiguous())], [want])


@pytest.mark.parametrize("lanes", [1, 3, 8])
def test_stacked_sort_ranks_above_the_threshold(cuda, lanes):
    keys = _rank_keys("int32_min", (lanes, 40_001),
                      torch.Generator().manual_seed(lanes)).to(cuda)
    before = kernels.LAUNCHES["sort_ranks"]
    got = sm_kernel.sort_ranks_cuda(keys)
    assert kernels.LAUNCHES["sort_ranks"] == before + 1
    assert _inverse_of_stable_argsort(got, keys)
    for w in range(lanes):
        _equal([got[w]], [sm_kernel.sort_ranks_cuda(keys[w].contiguous())])


def _layout_keys(kind, n_l, n_r, lanes, seed, device):
    """Left and right keys with shared values (ties), the invalid-row
    sentinel of each side and INT32_MIN; (lanes, n) when lanes."""
    gen = torch.Generator().manual_seed(seed)
    shape = (lambda n: (lanes, n)) if lanes else (lambda n: (n,))
    if kind == "equal":
        return (torch.full(shape(n_l), 5, dtype=torch.int32, device=device),
                torch.full(shape(n_r), 5, dtype=torch.int32, device=device))
    hi = max(2, min(n_l, n_r) // 4)
    sides = []
    for n, sentinel in ((n_l, INVALID_LEFT), (n_r, INVALID_RIGHT)):
        k = torch.randint(0, hi, shape(n), generator=gen, dtype=torch.int32)
        k[torch.rand(shape(n), generator=gen) < 0.15] = sentinel
        k[torch.rand(shape(n), generator=gen) < 0.05] = -(2**31)
        sides.append(k.to(device))
    return tuple(sides)


def _largest_compare_square():
    """The largest n with an n x n layout on the compare path."""
    lo, hi = 1, 1 << 16
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (lo, mid - 1) if sm_kernel.sorted_at(mid, mid) else (mid, hi)
    return lo


_LAYOUT_SHAPES = [  # (path, n_l, n_r); 0: the largest compare square
    ("compare", 0, 0), ("compare", 4096, 1024), ("compare", 5, 70001), ("compare", 256, 5000), ("compare", 257, 5000),
    ("sorted", 1, 1), ("sorted", 40001, 3),
    ("sorted", 70001, 1), ("sorted", 1 << 15, 100)]


@pytest.mark.parametrize("kind", ["ties", "equal"])
@pytest.mark.parametrize(("path", "n_l", "n_r"), _LAYOUT_SHAPES)
def test_match_layout_paths_equal_plain(cuda, path, n_l, n_r, kind):
    """Each path on its side of the threshold, at its edge (the largest
    compare square and the next one), and the compare path's column
    blocks on both sides of 256 left keys (a right key a thread up to
    it): 1 device launch on the compare path, 25 on the sort-and-search
    path, bit-equal to the dense plain version and to the sorted
    oracle."""
    if n_l == 0:
        n_l = n_r = _largest_compare_square()
    elif path == "sorted" and n_l == 1:
        n_l = n_r = _largest_compare_square() + 1
    assert sm_kernel.sorted_at(n_l, n_r) == (path == "sorted")
    lk, rk = _layout_keys(kind, n_l, n_r, 0, n_l + n_r, cuda)
    before = kernels.DEVICE_LAUNCHES["match_layout"]
    got = sm_ops.match_layout(lk, rk)
    launched = kernels.DEVICE_LAUNCHES["match_layout"] - before
    assert launched == (25 if path == "sorted" else 1)
    _equal(got, sm_ref.match_layout(lk, rk))
    _equal(got, sm_ref.match_layout_sorted(lk, rk))


@pytest.mark.parametrize(("n_l", "n_r"), [
    (1 << 20, 4), (4, 1 << 20), (32770, 65536)])
def test_match_layout_long_sides_equal_sorted_oracle(cuda, n_l, n_r):
    """Shapes the optimizer's cap admits: 2^20 left rows against 4 right
    keys, every left key matching (the sort-and-search path), and the
    transpose (the compare path); and all-equal keys whose b = counts *
    occ passes 2^31 and wraps as the reference's int32 sum."""
    if n_l == 32770:
        lk = torch.full((n_l,), 7, dtype=torch.int32, device=cuda)
        rk = torch.full((n_r,), 7, dtype=torch.int32, device=cuda)
    else:
        gen = torch.Generator().manual_seed(n_l)
        small = torch.arange(4, dtype=torch.int32)
        big = torch.randint(0, 4, (1 << 20,), generator=gen, dtype=torch.int32)
        lk, rk = ((big, small) if n_l > n_r else (small, big))
        lk, rk = lk.to(cuda), rk.to(cuda)
    got = sm_ops.match_layout(lk, rk)
    want = sm_ref.match_layout_sorted(lk, rk)
    _equal(got, want)
    if n_l == 1 << 20:
        assert sm_kernel.sorted_at(n_l, n_r)
        assert bool((got[0] == 1).all())
    if n_l == 32770:
        assert int(got[2][-1]) < 0
    _equal(got, sm_ref.match_layout(lk, rk))


@pytest.mark.parametrize(("path", "n_l", "n_r"), [
    ("compare", 700, 300), ("compare", 33, 4097),
    ("sorted", 40001, 37), ("sorted", 50001, 5)])
@pytest.mark.parametrize("lanes", [1, 3, 8])
def test_stacked_match_layout_paths_equal_single_calls(cuda, path, n_l, n_r,
                                                       lanes):
    """One launcher call for every lane, on each path; odd lengths leave
    lane rows off a 16-byte boundary."""
    assert sm_kernel.sorted_at(n_l, n_r) == (path == "sorted")
    lk, rk = _layout_keys("ties", n_l, n_r, lanes, lanes + n_l, cuda)
    before = kernels.LAUNCHES["match_layout"]
    got = sm_kernel.match_layout_cuda(lk, rk)
    assert kernels.LAUNCHES["match_layout"] == before + 1
    for w in range(lanes):
        single = sm_kernel.match_layout_cuda(lk[w].contiguous(),
                                             rk[w].contiguous())
        _equal([g[w] for g in got], single)
        _equal(single, sm_ref.match_layout(lk[w], rk[w]))


def test_sorted_at_is_monotone_in_each_side(cuda):
    sizes = [1, 2, 31, 32, 33, 1000, 4096, 10_000, 20_000, 32_768, 32_769,
             100_000, 1 << 20, 1 << 22]
    table = {(a, c): sm_kernel.sorted_at(a, c) for a in sizes for c in sizes}
    for (a, c), s in table.items():
        for a2 in sizes:
            if a2 >= a:
                assert table[(a2, c)] >= s, (a, a2, c)
        for c2 in sizes:
            if c2 >= c:
                assert table[(a, c2)] >= s, (a, c, c2)
    assert not sm_kernel.sorted_at(4096, 1024)
    assert sm_kernel.sorted_at(1 << 20, 4)


def test_bindings_refuse_what_the_kernels_do_not_take(cuda):
    x64 = torch.zeros(8, dtype=torch.int64, device=cuda)
    x32 = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        pe_kernel.pair_expand_cuda(x64, x64, 8)
    with pytest.raises(ValueError):
        sm_kernel.match_layout_cuda(x32[::2], x32)
    with pytest.raises(ValueError):
        sm_kernel.sort_ranks_cuda(x32.cpu())
    with pytest.raises(ValueError):
        sm_kernel.sort_ranks_cuda(x32[:0])


@pytest.mark.parametrize("backend", [None, "mr", "matrix"])
def test_engine_on_the_card_equals_the_cpu(cuda, backend):
    from repro_torch.sparql import lubm
    from repro_torch.sparql.engine import QueryEngine
    from repro_torch.sparql.store import TripleStore

    base = lubm.generate(scale=1, join_shapes=True, skew_shapes=True)
    terms = [base.dictionary.decode(i) for i in range(len(base.dictionary))]
    engines = [
        QueryEngine(TripleStore.from_arrays(base.triples, terms), device=d,
                    join_backend=backend)
        for d in (cuda, "cpu")
    ]
    queries = {**lubm.QUERIES, **lubm.OPERATOR_QUERIES, **lubm.S_QUERIES}
    for text in queries.values():
        for _ in range(2):
            on_card, on_cpu = (e.prepare(text).run() for e in engines)
            assert on_card.rows == on_cpu.rows
            assert on_card.stats.join_totals == on_cpu.stats.join_totals
        assert on_card.stats.n_dispatches == 1
        assert on_card.stats.n_compiles == 0


@pytest.mark.parametrize("mode", [
    {"optimize": False},
    {"exact_count_pass": False},
    {"exact_count_pass": False, "compiled": False},
], ids=["greedy", "double_on_overflow", "double_on_overflow_eager"])
def test_engine_modes_on_the_card_equal_the_cpu(cuda, mode):
    """The legacy planner and double-on-overflow sizing: the card's rows
    and ExecStats (retries included) are the CPU's."""
    from repro_torch.sparql import lubm
    from repro_torch.sparql.engine import QueryEngine
    from repro_torch.sparql.store import TripleStore

    base = lubm.generate(scale=1, join_shapes=True, skew_shapes=True)
    terms = [base.dictionary.decode(i) for i in range(len(base.dictionary))]
    engines = [
        QueryEngine(TripleStore.from_arrays(base.triples, terms), device=d,
                    **mode)
        for d in (cuda, "cpu")
    ]
    queries = {**lubm.QUERIES, **lubm.OPERATOR_QUERIES, **lubm.J_QUERIES,
               **lubm.S_QUERIES}
    fields = ("n_retries", "n_dispatches", "n_count_passes",
              "peak_join_bucket", "n_compiles")
    for text in queries.values():
        for _ in range(2):
            on_card, on_cpu = (e.prepare(text).run() for e in engines)
            assert on_card.rows == on_cpu.rows
            for f in fields:
                assert getattr(on_card.stats, f) == getattr(on_cpu.stats, f)


# ------------------------------------------------ stacked forms and vmap

@pytest.mark.parametrize("lanes", [1, 3, 8])
def test_stacked_kernels_equal_single_calls(cuda, lanes):
    gen = torch.Generator().manual_seed(lanes)
    counts = torch.randint(0, 5, (lanes, 900), generator=gen, dtype=torch.int32)
    prefix = torch.cumsum(counts, 1, dtype=torch.int32).to(cuda)
    counts = counts.to(cuda)
    got = pe_kernel.pair_expand_cuda(prefix, counts, 3000)
    for w in range(lanes):
        _equal([g[w] for g in got],
               pe_kernel.pair_expand_cuda(prefix[w], counts[w], 3000))
    lk = torch.stack([_keys(gen, 700, 11, INVALID_LEFT, "cpu") for _ in range(lanes)]).to(cuda)
    rk = torch.stack([_keys(gen, 300, 11, INVALID_RIGHT, "cpu") for _ in range(lanes)]).to(cuda)
    got = sm_kernel.match_layout_cuda(lk, rk)
    for w in range(lanes):
        _equal([g[w] for g in got], sm_ref.match_layout(lk[w], rk[w]))
    got = sm_kernel.sort_ranks_cuda(rk)
    for w in range(lanes):
        _equal([got[w]], [sm_ref.sort_ranks(rk[w])])


def test_vmap_launches_each_kernel_once(cuda):
    """torch.func.vmap over the public ops: one launch of the stacked form
    per call, whatever the lanes, with unbatched inputs broadcast."""
    gen = torch.Generator().manual_seed(5)
    counts = torch.randint(0, 5, (8, 500), generator=gen, dtype=torch.int32)
    prefix = torch.cumsum(counts, 1, dtype=torch.int32).to(cuda)
    counts = counts.to(cuda)
    keys = _keys(gen, 8 * 200, 9, INVALID_RIGHT, cuda).view(8, 200)
    before = dict(kernels.LAUNCHES)
    got = torch.func.vmap(lambda p, c: pe_ops.pair_expand(p, c, 2048))(prefix, counts)
    lay = torch.func.vmap(sm_ops.match_layout, in_dims=(0, None))(keys, keys[0])
    ranks = torch.func.vmap(sm_ops.sort_ranks)(keys)
    for k in ("pair_expand", "match_layout", "sort_ranks"):
        assert kernels.LAUNCHES[k] == before.get(k, 0) + 1, k
    for w in range(8):
        _equal([g[w] for g in got], pe_ref.pair_expand(prefix[w], counts[w], 2048))
        _equal([g[w] for g in lay], sm_ref.match_layout(keys[w], keys[0]))
        _equal([ranks[w]], [sm_ref.sort_ranks(keys[w])])


# ------------------------------------------------ bitonic sort, segment sum

def _pairs(k, v):
    return torch.sort(k.long() * 2**32 + (v.long() & 0xFFFFFFFF)).values


def _sort_and_check(keys, vals):
    """One sort_pairs call against the plain version: keys equal, (key,
    payload) multisets equal, and above one tile (the stable radix path)
    payloads equal; one launcher call of 1 device launch within the tile,
    12 above."""
    n = keys.shape[0]
    before = kernels.LAUNCHES["bitonic_sort"]
    before_dev = kernels.DEVICE_LAUNCHES["bitonic_sort"]
    sk, sv = sort_ops.sort_pairs(keys, vals)
    assert kernels.LAUNCHES["bitonic_sort"] == before + 1
    stable = sort_kernel.stable_at(n)
    assert stable == (n > 8192)  # one block sorts up to 8192 pairs
    assert kernels.DEVICE_LAUNCHES["bitonic_sort"] - before_dev == (
        12 if stable else 1)
    rk, rv = sort_ref.sort_pairs(keys, vals)
    torch.cuda.synchronize()
    assert torch.equal(sk, rk)
    assert torch.equal(_pairs(sk, sv), _pairs(rk, rv))
    if stable:
        assert torch.equal(sv, rv)
    return rk


@pytest.mark.parametrize(
    "n", [1, 2, 3, 17, 2047, 2048, 2049, 4096, 5000, (1 << 16) + 7, 1 << 19,
          8191, 8192, 8193, 16384, 16385, 8192 + 4096, (1 << 20) + 5]
)
def test_bitonic_sort_kernel_equals_plain(cuda, n):
    gen = torch.Generator().manual_seed(n)
    keys = torch.randint(-(2**31), 2**31 - 1, (n,), generator=gen, dtype=torch.int32)
    keys[: n // 2] %= 7  # duplicates
    keys[torch.rand(n, generator=gen) < 0.05] = 2**31 - 1
    vals = torch.randint(-(2**31), 2**31 - 1, (n,), generator=gen, dtype=torch.int32)
    keys, vals = keys.to(cuda), vals.to(cuda)
    rk = _sort_and_check(keys, vals)
    order = sort_ops.argsort_i32(keys)
    assert torch.equal(keys[order.long()], rk)
    assert torch.equal(torch.sort(order).values,
                       torch.arange(n, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("n", [8192, 8193, 70001])
@pytest.mark.parametrize(
    "pattern", ["equal", "int32_min", "int32_max", "sorted", "reversed"]
)
def test_bitonic_sort_special_inputs(cuda, n, pattern):
    """All-equal keys, all INT32_MIN / INT32_MAX (each keeps its own
    payload), sorted and reverse-sorted input, within and above one tile."""
    keys = {
        "equal": torch.full((n,), 7, dtype=torch.int32),
        "int32_min": torch.full((n,), -(2**31), dtype=torch.int32),
        "int32_max": torch.full((n,), 2**31 - 1, dtype=torch.int32),
        "sorted": torch.arange(n, dtype=torch.int32) * 3 - n,
        "reversed": torch.arange(n, 0, -1, dtype=torch.int32) * 1000,
    }[pattern].to(cuda)
    vals = torch.randperm(n, generator=torch.Generator().manual_seed(n),
                          dtype=torch.int64).to(torch.int32).to(cuda)
    _sort_and_check(keys, vals)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,s", [(10, 8, 4), (2048, 64, 128), (1000, 130, 33),
                                   (20000, 16, 5000), (0, 4, 3), (5000, 1, 40),
                                   (5000, 3, 40), (5000, 130, 40)])
def test_segment_sum_kernel_equals_plain(cuda, n, d, s, dtype):
    gen = torch.Generator().manual_seed(n + d + s)
    ids = torch.sort(torch.randint(-3, s + 3, (n,), generator=gen,
                                   dtype=torch.int32)).values.to(cuda)
    data = torch.randn(n, d, generator=gen).to(cuda)
    before = kernels.LAUNCHES["segment_reduce"]
    got = seg_ops.sorted_segment_sum(data.to(dtype), ids, s)
    assert kernels.LAUNCHES["segment_reduce"] == before + 1
    assert got.dtype == dtype and got.shape == (s, d)
    if dtype == torch.float32:
        want, tol = seg_ref.sorted_segment_sum(data, ids, s), (1e-5, 1e-4)
    else:  # the bf16 result against the float32 one, the reference's bounds
        want, tol = seg_ref.sorted_segment_sum(data, ids, s), (5e-2, 0.3)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, rtol=tol[0], atol=tol[1])


def _bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["one_segment", "skew", "gaps"])
def test_segment_sum_long_segments_and_gaps(cuda, case, dtype):
    """One segment spanning many chunks (alone, and holding half of a
    skewed input), and empty segments below the first id, between ids and
    above the last: within the tolerances of the exact (float64) sum for
    float32, of the float32 sum of the same bfloat16 inputs for bfloat16
    (over 2^17 rows the inputs' own rounding from float32 exceeds the
    bounds); two calls equal bit for bit."""
    gen = torch.Generator().manual_seed(11)
    if case == "one_segment":
        n, d, s = 300_000, 64, 10
        ids = torch.full((n,), 3, dtype=torch.int32)
    elif case == "skew":
        n, d, s = 1 << 18, 128, 512
        ids = torch.cat([torch.randint(0, s, (n // 2,), generator=gen,
                                       dtype=torch.int32),
                         torch.full((n // 2,), 7, dtype=torch.int32)])
    else:  # every 30th id from 10 up: gaps at both ends and between
        n, d, s = 30_000, 32, 1000
        ids = torch.randint(0, 30, (n,), generator=gen, dtype=torch.int32) * 30 + 10
    ids = torch.sort(ids).values.to(cuda)
    data = torch.randn(n, d, generator=gen).to(cuda)
    data = data.to(dtype)
    got = seg_ops.sorted_segment_sum(data, ids, s)
    again = seg_ops.sorted_segment_sum(data, ids, s)
    if dtype == torch.float32:
        want, tol = seg_ref.sorted_segment_sum(data.double(), ids, s), (1e-5, 1e-4)
    else:
        want = seg_ref.sorted_segment_sum(data.float(), ids, s).double()
        tol = (5e-2, 0.3)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(again))
    torch.testing.assert_close(got.double(), want, rtol=tol[0], atol=tol[1])
    if case == "gaps":
        present = torch.zeros(s, dtype=torch.bool, device=cuda)
        present[ids.long()] = True
        assert not got[~present].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,s", [(2048, 64, 128), (100_000, 130, 300),
                                   (70_000, 1, 50)])
def test_segment_sum_two_calls_are_bit_equal(cuda, n, d, s, dtype):
    gen = torch.Generator().manual_seed(n + d)
    ids = torch.sort(torch.randint(-2, s + 2, (n,), generator=gen,
                                   dtype=torch.int32)).values.to(cuda)
    data = torch.randn(n, d, generator=gen).to(cuda).to(dtype)
    before = kernels.DEVICE_LAUNCHES["segment_reduce"]
    first = seg_ops.sorted_segment_sum(data, ids, s)
    assert kernels.DEVICE_LAUNCHES["segment_reduce"] - before == 2
    assert torch.equal(_bits(first), _bits(seg_ops.sorted_segment_sum(data, ids, s)))


def test_new_bindings_refuse_what_the_kernels_do_not_take(cuda):
    x32 = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        sort_kernel.sort_pairs_cuda(x32.long(), x32)
    with pytest.raises(ValueError):
        sort_kernel.sort_pairs_cuda(x32, x32[:4])
    with pytest.raises(ValueError):
        seg_kernel.sorted_segment_sum_cuda(torch.zeros(8, 2, device=cuda).half(), x32, 3)
    with pytest.raises(ValueError):
        seg_kernel.sorted_segment_sum_cuda(torch.zeros(8, 2, device=cuda), x32[:4], 3)


# ------------------------------------------------ stacked batches, serving

def test_run_batch_on_the_card_equals_the_cpu(cuda):
    """Same-shape FILTER variants and near-miss padded shapes through
    run_batch: card arrays equal the CPU's, and a stacked dispatch
    launches each kernel as often as one warm single-query run."""
    from repro_torch.sparql import lubm
    from repro_torch.sparql.engine import QueryEngine
    from repro_torch.sparql.store import TripleStore

    base = lubm.generate(scale=1, join_shapes=True, skew_shapes=True)
    terms = [base.dictionary.decode(i) for i in range(len(base.dictionary))]
    engines = [QueryEngine(TripleStore.from_arrays(base.triples, terms), device=d)
               for d in (cuda, "cpu")]
    q4 = lubm.QUERIES["Q4"]
    texts = [q4.replace("Dept0_0", f"Dept0_{k}") for k in range(6)]
    texts += [lubm.S_QUERIES["S1"]] * 4
    results = []
    for eng in engines:
        pqs = [eng.prepare(t) for t in texts]
        for pq in pqs:
            pq.run()
        eng.run_batch(pqs)
        results.append(eng.run_batch(pqs))
    for a, b in zip(*results):
        assert a.rows == b.rows and a.stats.join_totals == b.stats.join_totals
    eng = engines[0]
    for text in (texts[0], texts[-1]):
        pq = eng.prepare(text)
        pq.run()
        before = dict(kernels.LAUNCHES)
        pq.run()
        single = {k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items()}
        before = dict(kernels.LAUNCHES)
        eng.run_batch([eng.prepare(text) for _ in range(8)])
        assert eng.last_batch[0].widths == (8,)
        stacked = {k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items()}
        assert stacked == single


def test_decode_on_another_thread_waits_for_a_side_stream_dispatch(cuda):
    """A query dispatched on a side stream and resolved on another thread
    (as the decode pool does): the fetch waits on the dispatch's event, so
    the rows equal the CPU's."""
    import threading

    from repro_torch.sparql import lubm
    from repro_torch.sparql.engine import QueryEngine
    from repro_torch.sparql.store import TripleStore

    base = lubm.generate(scale=1)
    terms = [base.dictionary.decode(i) for i in range(len(base.dictionary))]
    card, cpu = (QueryEngine(TripleStore.from_arrays(base.triples, terms),
                             device=d) for d in (cuda, "cpu"))
    text = lubm.QUERIES["Q9"]
    card.prepare(text).run()  # calibrate + compile
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        pendings = card.run_batch_pipelined([card.prepare(text)] * 4)
    got = [None] * 4

    def resolve(i):
        got[i] = pendings[i].resolve().rows

    threads = [threading.Thread(target=resolve, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    want = cpu.prepare(text).run().rows
    assert all(rows == want for rows in got)


# ------------------------------------------------ the sharded engine

SHARD_MESHES = {"1": (1, None), "4": (4, None), "8": (8, None),
                "2x2": (4, ((2, 2), ("pod", "data")))}


def _sharded_pair(cuda, config, **kw):
    """The sharded engine on the card and on the CPU, over one LUBM
    scale-1 store each."""
    from repro_torch.core.distributed import make_mesh
    from repro_torch.sparql import lubm
    from repro_torch.sparql.engine import ShardedQueryEngine
    from repro_torch.sparql.sharded_store import shard_store

    n, mesh = SHARD_MESHES[config]
    base = lubm.generate(scale=1, join_shapes=True, skew_shapes=True)
    return [
        ShardedQueryEngine(shard_store(base, n), device=d,
                           mesh=make_mesh(*mesh) if mesh else None, **kw)
        for d in (cuda, "cpu")
    ]


@pytest.mark.parametrize("backend", [None, "matrix"])
@pytest.mark.parametrize("config", list(SHARD_MESHES))
def test_sharded_engine_on_the_card_equals_the_cpu(cuda, config, backend):
    """Every query's result arrays, join totals and shuffle loads equal
    the CPU port's, cold and warm; warm runs are 1 dispatch, 0 compiles,
    and the warm program makes no host sync."""
    from repro_torch.sparql import lubm
    from repro_torch.sparql.parser import parse

    engines = _sharded_pair(cuda, config, join_backend=backend)
    queries = {**lubm.QUERIES, **lubm.OPERATOR_QUERIES, **lubm.S_QUERIES,
               **lubm.J_QUERIES}
    for text in queries.values():
        q = parse(text)
        for _ in range(2):
            (rc, sc), (rh, sh) = (e.execute(q) for e in engines)
            assert torch.equal(rc.cols.cpu(), rh.cols)
            assert torch.equal(rc.valid.cpu(), rh.valid)
            assert sc.join_totals == sh.join_totals
            assert sc.join_worst == sh.join_worst
            assert sc.shuffle_loads == sh.shuffle_loads
        assert sc.n_dispatches == 1 and sc.n_compiles == 0
        eng = engines[0]
        pq = eng.prepare(text)
        canon, shape, _ = eng._canonicalize(pq._program)
        consts = eng._device_consts(pq._program)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = eng.plan_cache.get(shape).compiled(canon, *consts)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert not bool(res.overflows.any())


@pytest.mark.parametrize("config", ["4", "2x2"])
def test_sharded_run_batch_and_retry_on_the_card_equal_the_cpu(cuda, config):
    """A stacked FILTER-constant group (one dispatch) and a program forced
    to the smallest join and shuffle buckets (retried): the card's rows
    equal the CPU's in order."""
    from repro_torch.sparql import lubm
    from repro_torch.sparql.engine import ExecStats

    engines = _sharded_pair(cuda, config)
    q4 = lubm.QUERIES["Q4"]
    texts = [q4.replace("Dept0_0", f"Dept0_{k}") for k in range(6)]
    results = []
    for eng in engines:
        pqs = [eng.prepare(t) for t in texts]
        pqs[0].run()
        eng.run_batch(pqs)
        out = eng.run_batch(pqs)
        assert eng.last_batch[0].widths == (8,)
        assert eng.last_batch[0].n_dispatches == 1
        pq = eng.prepare(lubm.QUERIES["Q9"])
        pq.run()
        shape = eng._batch_context(pq._program).shape
        entry = eng.plan_cache.get(shape)
        eng._compile_entry(
            shape, (8,) * len(entry.join_caps), ExecStats(),
            shuffle_caps=(8,) * len(entry.compiled.shuffle_caps),
        )
        retried = pq.run()
        assert retried.stats.n_retries >= 1
        results.append([r.rows for r in out] + [retried.rows])
    assert results[0] == results[1]


@pytest.mark.parametrize("mesh", ["4", "2x2"])
def test_shuffle_by_key_on_the_card_equals_the_cpu(cuda, mesh):
    from repro_torch.core.distributed import make_mesh, shuffle_by_key

    n, axes = SHARD_MESHES[mesh]
    m = make_mesh(*axes) if axes else make_mesh((n,), ("shards",))
    gen = torch.Generator().manual_seed(n)
    cols = torch.randint(-(2**31), 2**31 - 1, (3 * n, 5000, 2),
                         generator=gen, dtype=torch.int32)
    valid = torch.rand(3 * n, 5000, generator=gen) < 0.8
    want = shuffle_by_key(cols, valid, [1, 0], m, (2048,) * len(m.axis_sizes))
    got = shuffle_by_key(cols.to(cuda), valid.to(cuda), [1, 0], m,
                         (2048,) * len(m.axis_sizes))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("shape", [(3, 1000), (4, 1 << 19), (8, 5)])
def test_cumsum_i32_on_the_card_equals_torch(cuda, shape):
    from repro_torch.core.segments import cumsum_i32

    gen = torch.Generator().manual_seed(shape[1])
    x = torch.randint(-(2**30), 2**30, shape, generator=gen,
                      dtype=torch.int32).to(cuda)
    want = torch.cumsum(x, dim=-1, dtype=torch.int32)
    assert torch.equal(torch.func.vmap(cumsum_i32)(x), want)
    assert torch.equal(cumsum_i32(x[0]), want[0])


# ------------------------------------ the sharded engine across processes


@pytest.mark.parametrize("world,backend", [(2, "gloo"), (1, "nccl")])
def test_ranks_on_the_card_equal_the_cpu(cuda, tmp_path, world, backend):
    """One shard per rank on cuda:0 (two gloo ranks share the card; NCCL
    at world 1): the exchanges equal the one-process functions on the
    CPU; the engine's arrays, every run's ExecStats on every rank, the
    plan caches, the retry, the MemoryError, run_batch and an update
    equal the one-process CPU engine's, call for call."""
    import numpy as np

    from repro_torch.core.distributed import make_mesh
    from repro_torch.sparql import lubm
    from repro_torch.sparql.engine import ShardedQueryEngine
    from repro_torch.sparql.sharded_store import shard_store
    from test_torch_dist_ranks import (
        LANES, SEEDS, drive, engine_script, exchange_outputs, join_outputs,
        run_ranks, save_store,
    )

    mesh = make_mesh((world,), ("shards",))
    got = run_ranks(tmp_path, world, "exchange_prog", device="cuda:0",
                    backend=backend)
    for seed in SEEDS:
        want = exchange_outputs(mesh, seed)
        for r, rec in enumerate(got):
            for key, w in want.items():
                g = rec[seed]["exchanges"][key]
                for gi, wi in zip(g if isinstance(g, tuple) else (g,),
                                  w if isinstance(w, tuple) else (w,)):
                    if key not in ("gather_shards", "gather_relation"):
                        wi = wi.reshape(LANES, world, *wi.shape[1:])[:, r]
                    assert np.array_equal(gi, wi), key
        cols, valid, totals, _ = join_outputs(mesh, seed)
        cap = cols.shape[0] // world
        for r, rec in enumerate(got):
            assert np.array_equal(rec[seed]["join"][0],
                                  cols[r * cap:(r + 1) * cap])
            assert np.array_equal(rec[seed]["join"][2], totals[r:r + 1])

    base = lubm.generate(scale=1, join_shapes=True, skew_shapes=True)
    queries = {**lubm.QUERIES, **lubm.OPERATOR_QUERIES, **lubm.S_QUERIES}
    new = "<http://example.org/NewStudent>"
    update = lubm.PREFIX + (
        f"INSERT DATA {{ {new} ub:takesCourse "
        f"<http://example.org/Course0_0_0> . }}")
    batch = [lubm.OPERATOR_QUERIES["F1"].replace("prof_0_0_0", v)
             for v in ("prof_0_0_0", "prof_1_0_0", "nobody")]

    def make_engine(warmup, max_capacity):
        kw = {} if max_capacity is None else {"max_capacity": max_capacity}
        return ShardedQueryEngine(shard_store(base, world), device="cpu",
                                  mesh=mesh, warmup_path=warmup, **kw)

    script = engine_script(tmp_path, make_engine, queries, batch, update,
                           lubm.QUERIES["Q1"], ("Q2", "Q9"))
    one = drive(make_engine, script)
    ranks = run_ranks(tmp_path, world, "engine_prog",
                      save_store(base, tmp_path / "store.npz"),
                      dict(script, save=str(tmp_path / "ranks.json")),
                      device="cuda:0", backend=backend)
    for name, ref in one["queries"].items():
        rec = ranks[0]["queries"][name]
        assert np.array_equal(rec["cols"], ref["cols"]), name
        assert np.array_equal(rec["valid"], ref["valid"]), name
        assert rec["rows"] == ref["rows"], name
    for rec in ranks:
        assert rec["calls"] == one["calls"]
        assert rec["engines"] == one["engines"]
    assert ranks[0]["batches"] == one["batches"]
    assert ranks[0]["after_update"] == one["after_update"]


LM_ARCHS = ["deepseek-67b", "gemma3-1b", "granite-moe-3b-a800m", "olmoe-1b-7b",
            "qwen2.5-32b"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_on_the_card_equals_the_cpu(cuda, arch, dtype):
    """The reduced config of each LM arch, the same seeded weights on the
    card and on the CPU: float32 logits within rtol/atol 1e-4 and greedy
    tokens equal (decoded with sync debugging at "error"); bf16 logits
    within 5e-2. TF32 stays off, or the float32 comparison means nothing."""
    import dataclasses
    import importlib

    import numpy as np

    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch.train import reduced_lm
    from repro_torch.models import transformer as T
    from repro_torch.serve.decode import Generator

    assert not torch.backends.cuda.matmul.allow_tf32
    dt = getattr(torch, dtype)
    cfg = dataclasses.replace(
        reduced_lm(importlib.import_module(ARCHS[arch]).CONFIG), dtype=dt)
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 32)).astype(
        np.int32)
    tokens = torch.from_numpy(prompts)
    card = Generator(cfg, params, device=cuda, max_len=40)
    with torch.inference_mode():
        want = T.forward(params, tokens, cfg)[0].float()
        got = T.forward(card.params, tokens.to(cuda), cfg)[0].float().cpu()
    if dt == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        on_card = tokens.to(cuda)  # a host-to-card copy syncs: not inside
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = card.generate_on_device(on_card, 8)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        cpu = Generator(cfg, params, device="cpu", max_len=40)
        np.testing.assert_array_equal(out.cpu().numpy(),
                                      cpu.generate(prompts, 8))
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=5e-2)


GNN_CASES = {
    # name: (arch, changes to the reduced config, make_full_graph arguments)
    "gat-cora": ("gat-cora", {}, (40, 90, 96, 12, 3)),
    "schnet": ("schnet", {}, (40, 90, 96, 1, 3)),
    "meshgraphnet": ("meshgraphnet", {}, (40, 90, 96, 8, 3)),
    "graphcast": ("graphcast", {}, (40, 90, 96, 6, 3)),
    "graphcast-streamed": ("graphcast", {"edge_stream_chunks": 4},
                           (300, 2000, 2048, 6, 3)),
    "graphcast-bf16": ("graphcast", {"compute_dtype": torch.bfloat16},
                       (40, 90, 96, 6, 3)),
}


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _without_sync(fn):
    """fn() with sync debugging at "error": a host sync inside raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("case", sorted(GNN_CASES))
def test_gnn_on_the_card_equals_the_cpu(cuda, case):
    """The reduced config of each GNN arch, the same seeded weights on the
    card and on the CPU port: the forward (with sync debugging at "error",
    every aggregation one segment_reduce launch) and the loss within
    rtol/atol 1e-4 in float32, 5e-2 with a bf16 compute_dtype. TF32 off."""
    import dataclasses
    import importlib

    from repro_torch.configs.registry import ARCHS, _gnn_module
    from repro_torch.data.graphs import make_full_graph, to_device
    from repro_torch.launch.train import reduced_gnn

    assert not torch.backends.cuda.matmul.allow_tf32
    arch, changes, graph = GNN_CASES[case]
    cfg = dataclasses.replace(
        reduced_gnn(arch, importlib.import_module(ARCHS[arch]).CONFIG),
        **changes)
    mod = _gnn_module(arch)
    g_np = make_full_graph(arch, *graph)
    params = mod.init_params(torch.Generator().manual_seed(0), cfg)
    g_cpu, g_dev = to_device(g_np, "cpu"), to_device(g_np, cuda)
    p_dev = _tree_to(params, cuda)
    kernels.LAUNCHES.clear()
    got = _without_sync(lambda: mod.apply(p_dev, g_dev, cfg)).cpu()
    assert kernels.LAUNCHES["segment_reduce"] > 0
    loss = _without_sync(lambda: mod.loss_fn(p_dev, g_dev, cfg)).cpu()
    with torch.inference_mode():
        want = mod.apply(params, g_cpu, cfg)
        want_loss = mod.loss_fn(params, g_cpu, cfg)
    tol = 5e-2 if "compute_dtype" in changes else 1e-4
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    torch.testing.assert_close(loss, want_loss, rtol=tol, atol=tol)


def test_deepfm_on_the_card_equals_the_cpu(cuda):
    """DeepFM's small config (and its published embedding width, 10):
    sigmoid(forward), bce_loss and retrieval_scores, card against the CPU
    port within rtol/atol 1e-4, the forward with sync debugging at
    "error" launching segment_reduce for both bags."""
    from repro_torch.data.recsys import CTRPipeline
    from repro_torch.models.recsys import deepfm as D

    for cfg in (D.DeepFMConfig(n_sparse=6, embed_dim=4, mlp_dims=(16, 16),
                               rows_per_field=50),
                D.DeepFMConfig(n_sparse=39, embed_dim=10,
                               mlp_dims=(40, 40, 40), rows_per_field=300)):
        params = D.init_params(torch.Generator().manual_seed(1), cfg)
        p_dev = _tree_to(params, cuda)
        b = CTRPipeline(cfg.n_sparse, cfg.rows_per_field, 64).batch_at(0)
        ids, labels = torch.from_numpy(b["ids"]), torch.from_numpy(b["labels"])
        cand = ids[:, :cfg.n_item_fields] % cfg.rows_per_field
        ids_dev, labels_dev, cand_dev = (ids.to(cuda), labels.to(cuda),
                                         cand.to(cuda))
        kernels.LAUNCHES.clear()
        probs = _without_sync(
            lambda: torch.sigmoid(D.forward(p_dev, ids_dev, cfg))).cpu()
        assert kernels.LAUNCHES["segment_reduce"] == 2
        loss = _without_sync(
            lambda: D.bce_loss(p_dev, ids_dev, labels_dev, cfg)).cpu()
        scores = _without_sync(
            lambda: D.retrieval_scores(p_dev, ids_dev[:1], cand_dev, cfg)).cpu()
        with torch.inference_mode():
            torch.testing.assert_close(
                probs, torch.sigmoid(D.forward(params, ids, cfg)),
                rtol=1e-4, atol=1e-4)
            torch.testing.assert_close(
                loss, D.bce_loss(params, ids, labels, cfg), rtol=1e-4,
                atol=1e-4)
            torch.testing.assert_close(
                scores, D.retrieval_scores(params, ids[:1], cand, cfg),
                rtol=1e-4, atol=1e-4)


def test_gnn_segment_ops_on_the_card_launch_the_kernel(cuda):
    """core.segments.sorted_segment_sum, gnn.common.aggregate and
    deepfm.embedding_bag_local launch segment_reduce on CUDA tensors (1-D,
    3-D and width-1 data too) and equal the plain version; a type the
    kernel does not take raises, with no route to the plain version."""
    from repro_torch.core import segments as S
    from repro_torch.models.gnn import common as C
    from repro_torch.models.recsys import deepfm as D

    gen = torch.Generator().manual_seed(3)
    ids = torch.sort(torch.randint(-2, 70, (500,), generator=gen,
                                   dtype=torch.int32)).values
    for shape in ((500,), (500, 1), (500, 4, 5)):
        data = torch.randn(shape, generator=gen)
        kernels.LAUNCHES.clear()
        got = S.sorted_segment_sum(data.to(cuda), ids.to(cuda), 64)
        assert kernels.LAUNCHES["segment_reduce"] == 1
        torch.testing.assert_close(got.cpu(), S.sorted_segment_sum(data, ids, 64),
                                   rtol=1e-5, atol=1e-5)
    msg = torch.randn(500, 8, generator=gen)
    mask = torch.rand(500, generator=gen) < 0.9
    kernels.LAUNCHES.clear()
    got = C.aggregate(msg.to(cuda), ids.to(cuda), 64, mask.to(cuda))
    assert kernels.LAUNCHES["segment_reduce"] == 1
    torch.testing.assert_close(got.cpu(), C.aggregate(msg, ids, 64, mask),
                               rtol=1e-5, atol=1e-5)
    table = torch.randn(90, 10, generator=gen)
    flat = torch.randint(-3, 95, (500,), generator=gen, dtype=torch.int32)
    kernels.LAUNCHES.clear()
    got = D.embedding_bag_local(table.to(cuda), flat.to(cuda), ids.to(cuda), 64)
    assert kernels.LAUNCHES["segment_reduce"] == 1
    torch.testing.assert_close(
        got.cpu(), D.embedding_bag_local(table, flat, ids, 64),
        rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        S.sorted_segment_sum(msg.double().to(cuda), ids.to(cuda), 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,s", [(5000, 64, 300), (2000, 10, 2000),
                                   (300, 7, 1)])
def test_segment_sum_autograd_on_the_card_is_the_kernel_and_a_gather(
        cuda, n, d, s, dtype):
    """With a gradient the forward is the kernel's, bit for bit, launched
    once; the backward equals the plain version's backward exactly (a row
    gather, dropped ids at zero) in the data's dtype."""
    gen = torch.Generator().manual_seed(n + s)
    ids = torch.sort(torch.randint(-3, s + 4, (n,), generator=gen,
                                   dtype=torch.int32)).values.to(cuda)
    data = torch.randn((n, d), generator=gen).to(dtype).to(cuda)
    g = torch.randn((s, d), generator=gen).to(dtype).to(cuda)
    with torch.no_grad():
        plain_fwd = seg_ops.sorted_segment_sum(data, ids, s)
    x = data.clone().requires_grad_(True)
    y = data.clone().requires_grad_(True)
    before = kernels.LAUNCHES["segment_reduce"]
    out = seg_ops.sorted_segment_sum(x, ids, s)
    assert kernels.LAUNCHES["segment_reduce"] == before + 1
    assert out.requires_grad and torch.equal(out, plain_fwd)
    out.backward(g)
    seg_ref.sorted_segment_sum(y, ids, s).backward(g)
    torch.cuda.synchronize()
    assert x.grad.dtype == dtype and torch.equal(x.grad, y.grad)
    assert kernels.LAUNCHES["segment_reduce"] == before + 1  # no kernel


def _assert_grads_close(name, got, want, exact, bound=1e-4):
    """Card gradients against the CPU port's: each leaf within `bound`
    relative L2 of its own norm; a leaf whose float64 gradient is zero
    (GAT's last a_dst when every score of a segment lies on one side of
    the leaky ReLU) within 1e-4 of the whole gradient's norm
    (`_torch_trees`)."""
    from _torch_trees import assert_grads_close

    from repro_torch import tree as TT

    assert_grads_close(name, TT.paths(want), TT.leaves(got), TT.leaves(want),
                       TT.leaves(exact), bound)


TRAIN_GNN_CASES = {
    "gat-cora": ("gat-cora", {}, (40, 90, 96, 12, 3)),
    "schnet": ("schnet", {}, (40, 90, 96, 1, 3)),
    "meshgraphnet-remat": ("meshgraphnet", {"remat": True}, (40, 90, 96, 8, 3)),
    "graphcast-streamed-remat": ("graphcast", {"edge_stream_chunks": 4,
                                               "remat": True},
                                 (300, 2000, 2048, 6, 3)),
}


@pytest.mark.parametrize("case", sorted(TRAIN_GNN_CASES))
def test_gnn_train_step_on_the_card_equals_the_cpu(cuda, case):
    """Every gradient leaf of the loss, card against the CPU port, within
    relative L2 1e-4 (`_assert_grads_close`), the params upstream of every
    aggregation included (the kernel's backward); then one registry train
    step with a warmup of 2 (lr 1.5e-4, so an update is well above the
    params' 1e-5): params within 1e-5. segment_reduce launches once per
    aggregation, and again for each rematerialized block."""
    import dataclasses
    import importlib

    from _torch_trees import float64_grad

    from repro_torch import tree as TT
    from repro_torch.configs.registry import (
        ARCHS, DEFAULT_OPT, _gnn_module, gnn_train_step)
    from repro_torch.data.graphs import make_full_graph, to_device
    from repro_torch.launch.train import reduced_gnn
    from repro_torch.models.gnn.graphcast import _pick_chunks
    from repro_torch.optim.adamw import adamw_init

    assert not torch.backends.cuda.matmul.allow_tf32
    arch, changes, graph = TRAIN_GNN_CASES[case]
    cfg = dataclasses.replace(
        reduced_gnn(arch, importlib.import_module(ARCHS[arch]).CONFIG),
        **changes)
    mod = _gnn_module(arch)
    g_np = make_full_graph(arch, *graph)
    params = mod.init_params(torch.Generator().manual_seed(4), cfg)
    g_cpu, g_dev = to_device(g_np, "cpu"), to_device(g_np, cuda)
    p_dev = _tree_to(params, cuda)
    kernels.LAUNCHES.clear()
    got = TT.grad(mod.loss_fn, p_dev, g_dev, cfg, has_aux=False)
    launches = kernels.LAUNCHES["segment_reduce"]
    want = TT.grad(mod.loss_fn, params, g_cpu, cfg, has_aux=False)
    _assert_grads_close(case, got, want,
                        float64_grad(mod.loss_fn, params, g_cpu, cfg=cfg))
    if arch in ("gat-cora", "meshgraphnet"):
        fwd = cfg.n_layers
    elif arch == "schnet":
        fwd = cfg.n_interactions + 1
    else:
        fwd = cfg.n_layers + sum(_pick_chunks(e, cfg.edge_stream_chunks)
                                 for e in (g_np.n_edges,
                                           g_np.extras["m2g_src"].shape[0]))
    assert launches == fwd * (2 if getattr(cfg, "remat", False) else 1)
    step = gnn_train_step(mod, cfg, dataclasses.replace(DEFAULT_OPT,
                                                        warmup_steps=2))
    p1, _, m = step(p_dev, adamw_init(p_dev), g_dev)
    q1, _, n = step(params, adamw_init(params), g_cpu)
    torch.testing.assert_close(m["grad_norm"].cpu(), n["grad_norm"],
                               rtol=1e-4, atol=1e-4)
    for a, b in zip(TT.leaves(p1), TT.leaves(q1)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)


def test_deepfm_train_step_on_the_card_equals_the_cpu(cuda):
    """The table's dense gradient (through the kernel's backward) and the
    MLP's, card against the CPU port, within relative L2 1e-4; one train
    step (warmup 2, lr 1.5e-4) with params within 1e-5; two segment_reduce
    launches a step."""
    import dataclasses

    from _torch_trees import float64_grad

    from repro_torch import tree as TT
    from repro_torch.configs.registry import DEFAULT_OPT, deepfm_train_step
    from repro_torch.data.recsys import CTRPipeline
    from repro_torch.models.recsys import deepfm as D
    from repro_torch.optim.adamw import adamw_init

    cfg = D.DeepFMConfig(n_sparse=39, embed_dim=10, mlp_dims=(40, 40, 40),
                         rows_per_field=300)
    params = D.init_params(torch.Generator().manual_seed(2), cfg)
    p_dev = _tree_to(params, cuda)
    b = CTRPipeline(cfg.n_sparse, cfg.rows_per_field, 256).batch_at(0)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    batch_dev = {k: v.to(cuda) for k, v in batch.items()}
    kernels.LAUNCHES.clear()
    got = TT.grad(D.bce_loss, p_dev, batch_dev["ids"], batch_dev["labels"],
                  cfg, has_aux=False)
    assert kernels.LAUNCHES["segment_reduce"] == 2
    want = TT.grad(D.bce_loss, params, batch["ids"], batch["labels"], cfg,
                   has_aux=False)
    assert bool(want["table"].any())
    _assert_grads_close("deepfm", got, want, float64_grad(
        D.bce_loss, params, batch["ids"], batch["labels"], cfg=cfg))
    step = deepfm_train_step(cfg, dataclasses.replace(DEFAULT_OPT,
                                                      warmup_steps=2))
    p1, _, _ = step(p_dev, adamw_init(p_dev), batch_dev)
    q1, _, _ = step(params, adamw_init(params), batch)
    for a, w in zip(TT.leaves(p1), TT.leaves(q1)):
        torch.testing.assert_close(a.cpu(), w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", ["gemma3-1b", "olmoe-1b-7b", "qwen2.5-32b"])
def test_lm_train_step_on_the_card_equals_the_cpu(cuda, arch, n_micro):
    """One float32 train step of a reduced LM arch, card against the CPU
    port: loss, aux and grad norm within rtol/atol 1e-4, every updated
    leaf within 1e-5."""
    import dataclasses
    import importlib

    import numpy as np

    from repro_torch import tree as TT
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch.train import reduced_lm
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    cfg = dataclasses.replace(
        reduced_lm(importlib.import_module(ARCHS[arch]).CONFIG),
        dtype=torch.float32)
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 33)).astype(np.int32))
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    step = T.make_train_step(cfg, AdamWConfig(warmup_steps=10), n_micro)
    p1, s1, m1 = step(_tree_to(params, cuda), adamw_init(_tree_to(params, cuda)),
                      {k: v.to(cuda) for k, v in batch.items()})
    p0, s0, m0 = step(params, adamw_init(params), batch)
    for k in ("loss", "aux", "grad_norm"):
        torch.testing.assert_close(m1[k].cpu(), m0[k], rtol=1e-4, atol=1e-4)
    for a, b in zip(TT.leaves(p1), TT.leaves(p0)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)


# -- the cells (phase 15's count check, at one-rank meshes) ----------------------


@pytest.mark.parametrize("arch,shape", [("gat-cora", "full_graph_sm"),
                                        ("deepfm", "serve_p99"),
                                        ("mapsq", "join_1m")])
def test_cell_counts_on_the_card_equal_the_meta_trace(cuda, arch, shape):
    """One step of the cell on a one-rank mesh: the FLOPs, the bytes
    (each kernel one op) and the kernel calls on the card equal the meta
    trace's exactly."""
    from repro_torch.configs.registry import build_cell
    from repro_torch.core.distributed import make_mesh
    from repro_torch.launch.dryrun import count_step

    cell = build_cell(arch, shape, make_mesh((1, 1), ("data", "model")),
                      False)
    meta = count_step(cell.fn, cell.local(), memory=False)
    card = count_step(cell.fn, cell.materialize(0, cuda), memory=False)
    assert card["flops"] == meta["flops"]
    assert card["bytes"] == meta["bytes"]
    assert card["kernels"] == meta["kernels"]
