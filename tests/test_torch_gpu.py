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
    "n_left,capacity", [(1, 1), (1, 1000), (2, 7), (700, 1500), (1 << 16, 1 << 18)]
)
def test_pair_expand_kernel_equals_plain(cuda, n_left, capacity):
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


@pytest.mark.parametrize(
    "n", [1, 2, 3, 17, 2047, 2048, 2049, 4096, 5000, (1 << 16) + 7, 1 << 19]
)
def test_bitonic_sort_kernel_equals_plain(cuda, n):
    gen = torch.Generator().manual_seed(n)
    keys = torch.randint(-(2**31), 2**31 - 1, (n,), generator=gen, dtype=torch.int32)
    keys[: n // 2] %= 7  # duplicates
    keys[torch.rand(n, generator=gen) < 0.05] = 2**31 - 1
    vals = torch.randint(-(2**31), 2**31 - 1, (n,), generator=gen, dtype=torch.int32)
    keys, vals = keys.to(cuda), vals.to(cuda)
    before = kernels.LAUNCHES["bitonic_sort"]
    sk, sv = sort_ops.sort_pairs(keys, vals)
    assert kernels.LAUNCHES["bitonic_sort"] == before + 1
    rk, rv = sort_ref.sort_pairs(keys, vals)
    torch.cuda.synchronize()
    assert torch.equal(sk, rk)
    assert torch.equal(_pairs(sk, sv), _pairs(rk, rv))
    order = sort_ops.argsort_i32(keys)
    assert torch.equal(keys[order.long()], rk)
    assert torch.equal(torch.sort(order).values,
                       torch.arange(n, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,s", [(10, 8, 4), (2048, 64, 128), (1000, 130, 33),
                                   (20000, 16, 5000), (0, 4, 3)])
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
