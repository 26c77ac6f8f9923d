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
