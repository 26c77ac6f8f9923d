// ReduceDuplicate pair expansion (the expand half of MapSQ's Algorithm 1).
//
// Replaces the Pallas TPU kernel `_pair_expand_kernel` in
// src/repro/kernels/pair_expand/kernel.py (launched by pair_expand_pallas).
//
// For every output slot t < capacity: i = the first index with inclusive
// prefix[i] > t (clamped to n_left - 1), off = t - (prefix[i] - counts[i]),
// valid = t < prefix[n_left - 1]. Slots past the total keep the clamped
// row and its offset, exactly as the TPU kernel and the jnp reference
// compute them.
//
// Stacked form: `lanes` independent rows of (n_left,) inputs and
// (capacity,) outputs, the lane in the grid's y dimension, so a stacked
// same-shape batch is one launch (the reference vmaps the Pallas call).
// A single call is the one-lane case.
//
// Bound on the H100: memory. Each slot writes 9 bytes (two int32 and a
// bool) and reads O(log n_left) words of `prefix`; the prefix array is at
// most a few MB at the engine's buckets, so after the first touches it sits
// in the 50 MB L2 and the slot writes dominate. Design: one thread per
// slot, a branch-light binary search through read-only (__ldg) loads of
// prefix in global memory, neighbouring threads on neighbouring slots so
// the three stores coalesce. The TPU kernel held prefix whole in VMEM and
// stepped all lanes through the same log2(n) schedule; here the L2 plays
// VMEM's part and no shared-memory staging is needed.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void pair_expand_kernel(const int* __restrict__ prefix,
                                   const int* __restrict__ counts,
                                   int n_left, int capacity,
                                   int* __restrict__ out_i,
                                   int* __restrict__ out_off,
                                   bool* __restrict__ out_valid) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= capacity) return;
  const size_t in_base = static_cast<size_t>(blockIdx.y) * n_left;
  const size_t out = static_cast<size_t>(blockIdx.y) * capacity + t;
  prefix += in_base;
  counts += in_base;
  int lo = 0;
  int hi = n_left;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(prefix + mid) <= t) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int i = lo < n_left - 1 ? lo : n_left - 1;
  const int start = __ldg(prefix + i) - __ldg(counts + i);
  out_i[out] = i;
  out_off[out] = t - start;
  out_valid[out] = t < __ldg(prefix + n_left - 1);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch.
// Requires 1 <= lanes <= 65535, n_left >= 1 and capacity >= 1 (the binding
// checks all three).
extern "C" int pair_expand_launch(const int* prefix, const int* counts,
                                  int lanes, int n_left, int capacity,
                                  int* out_i, int* out_off, bool* out_valid,
                                  cudaStream_t stream) {
  const dim3 grid((capacity + kThreads - 1) / kThreads, lanes);
  pair_expand_kernel<<<grid, kThreads, 0, stream>>>(
      prefix, counts, n_left, capacity, out_i, out_off, out_valid);
  return static_cast<int>(cudaGetLastError());
}
