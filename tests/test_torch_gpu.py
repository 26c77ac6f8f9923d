"""Card-only tests of the port: the CUDA kernels against their plain
versions, and the engine on the card against the engine on the CPU.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card every test here skips (the check is made in the `cuda`
fixture, so every pytest worker collects the same tests)."""
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.pair_expand import kernel as pe_kernel
from repro_torch.kernels.pair_expand import ops as pe_ops
from repro_torch.kernels.pair_expand import ref as pe_ref
from repro_torch.kernels.spmm_join import kernel as sm_kernel
from repro_torch.kernels.spmm_join import ops as sm_ops
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
