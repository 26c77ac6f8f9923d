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
