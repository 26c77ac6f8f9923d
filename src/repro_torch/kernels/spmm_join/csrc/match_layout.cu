// The matrix join's output layout from dense key compares (match_layout).
//
// Replaces the Pallas TPU kernel `_match_layout_kernel` in
// src/repro/kernels/spmm_join/kernel.py (launched by match_layout_pallas).
//
// With E[i,j] = [lk_i == rk_j]:
//   counts[i] = sum_j E[i,j]             first[i] = sum_j [rk_j < lk_i]
//   b[i]      = sum_j E[i,j] * #{i' < i : lk_i' == rk_j}
//   cl[j]     = sum_i E[i,j]
//
// The TPU kernel carries the column sums of E from one grid step to the
// next in a revisited output block; that is sound only because TPU grid
// steps run in order, and CUDA blocks do not. The carry is dropped here:
// E[i,j] = 1 implies rk_j == lk_i, so b[i] = counts[i] * occ[i] with
// occ[i] = #{i' < i : lk_i' == lk_i}, and every output is an independent
// per-row sum. Two kernels, no atomics, deterministic, bit-equal to the
// TPU kernel and the jnp reference for every key, sentinels included:
//   rows: one thread per left row streams the right keys through a
//         shared-memory tile (counts, first), then the left keys before
//         its block's end (occ), skipping that pass when no row of the
//         block matched anything (b = 0 there);
//   cols: one thread per right row streams the left keys (cl).
//
// Stacked form: `lanes` independent (lk, rk) pairs, the lane in the grid's
// y dimension, so a stacked same-shape batch is one call (the reference
// vmaps the Pallas call). A single call is the one-lane case.
//
// Bound on the H100: operations. The compares are n_l * n_r (rows) +
// n_l * n_r (cols) + up to n_l^2 / 2 (occ), int32 compare-and-add on the
// CUDA cores; the bytes are (n_l + n_r) * 4 in and (3 n_l + n_r) * 4 out.
// Each tile word is read once from device memory per block and then
// broadcast from shared memory to all threads of the block. The occ pass
// is quadratic in n_l; the optimizer only routes joins with
// |L| * |R| <= 2^22 here, where it stays small beside the compare pass.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;

__global__ void layout_rows_kernel(const int* __restrict__ lk,
                                   const int* __restrict__ rk, int n_l,
                                   int n_r, int* __restrict__ counts,
                                   int* __restrict__ first,
                                   int* __restrict__ b) {
  __shared__ int tile[kTile];
  const size_t lane_l = static_cast<size_t>(blockIdx.y) * n_l;
  lk += lane_l;
  rk += static_cast<size_t>(blockIdx.y) * n_r;
  counts += lane_l;
  first += lane_l;
  b += lane_l;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n_l;
  const int key = live ? lk[i] : 0;
  int c = 0;
  int f = 0;
  for (int base = 0; base < n_r; base += kTile) {
    const int m = min(kTile, n_r - base);
    for (int k = threadIdx.x; k < m; k += kThreads) tile[k] = rk[base + k];
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < m; ++k) {
      const int r = tile[k];
      c += r == key;
      f += r < key;
    }
    __syncthreads();
  }
  int occ = 0;
  const int block_end = min(n_l, (blockIdx.x + 1) * kThreads);
  if (__syncthreads_or(live && c > 0)) {
    for (int base = 0; base < block_end; base += kTile) {
      const int m = min(kTile, block_end - base);
      for (int k = threadIdx.x; k < m; k += kThreads) tile[k] = lk[base + k];
      __syncthreads();
      const int before = i - base;  // tile entries k < before precede row i
#pragma unroll 8
      for (int k = 0; k < m; ++k) occ += (tile[k] == key) & (k < before);
      __syncthreads();
    }
  }
  if (live) {
    counts[i] = c;
    first[i] = f;
    b[i] = c * occ;
  }
}

__global__ void layout_cols_kernel(const int* __restrict__ lk,
                                   const int* __restrict__ rk, int n_l,
                                   int n_r, int* __restrict__ cl) {
  __shared__ int tile[kTile];
  lk += static_cast<size_t>(blockIdx.y) * n_l;
  const size_t lane_r = static_cast<size_t>(blockIdx.y) * n_r;
  rk += lane_r;
  cl += lane_r;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int key = j < n_r ? rk[j] : 0;
  int c = 0;
  for (int base = 0; base < n_l; base += kTile) {
    const int m = min(kTile, n_l - base);
    for (int k = threadIdx.x; k < m; k += kThreads) tile[k] = lk[base + k];
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < m; ++k) c += tile[k] == key;
    __syncthreads();
  }
  if (j < n_r) cl[j] = c;
}

}  // namespace

// Launch both kernels on `stream`; returns cudaGetLastError() after them.
// Requires 1 <= lanes <= 65535, n_l >= 1 and n_r >= 1 (the binding checks
// all three).
extern "C" int match_layout_launch(const int* lk, const int* rk, int lanes,
                                   int n_l, int n_r, int* counts, int* first,
                                   int* b, int* cl, cudaStream_t stream) {
  const dim3 rows_grid((n_l + kThreads - 1) / kThreads, lanes);
  layout_rows_kernel<<<rows_grid, kThreads, 0, stream>>>(lk, rk, n_l, n_r,
                                                        counts, first, b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 cols_grid((n_r + kThreads - 1) / kThreads, lanes);
  layout_cols_kernel<<<cols_grid, kThreads, 0, stream>>>(lk, rk, n_l, n_r,
                                                        cl);
  return static_cast<int>(cudaGetLastError());
}
