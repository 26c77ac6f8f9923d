// Stable sorted position of every key, without a sort (sort_ranks).
//
// Replaces the Pallas TPU kernel `_sort_ranks_kernel` in
// src/repro/kernels/spmm_join/kernel.py (launched by sort_ranks_pallas).
//
//   rank[i] = #{j : k_j < k_i} + #{j < i : k_j == k_i}
//
// Stacked form: `lanes` independent key rows, the lane in the grid's y
// dimension (one launch for a stacked batch; one lane for a single call).
//
// Bound on the H100: operations, n^2 int32 compares (n * 4 bytes in,
// n * 4 bytes out). Design: one thread per row; the keys are streamed
// through a shared-memory tile, read once from device memory per block and
// broadcast to its threads, as the TPU kernel walked its VMEM-resident keys
// in CHUNK-wide slices. The ragged edge is masked here; the TPU wrapper's
// padding to 1024 rows does not carry over. The quadratic work is what the
// TPU kernel does too: it orders only the right side of a matrix join,
// which the optimizer keeps small.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;

__global__ void sort_ranks_kernel(const int* __restrict__ keys, int n,
                                  int* __restrict__ rank) {
  __shared__ int tile[kTile];
  const size_t lane = static_cast<size_t>(blockIdx.y) * n;
  keys += lane;
  rank += lane;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int key = i < n ? keys[i] : 0;
  int acc = 0;
  for (int base = 0; base < n; base += kTile) {
    const int m = min(kTile, n - base);
    for (int k = threadIdx.x; k < m; k += kThreads) tile[k] = keys[base + k];
    __syncthreads();
    const int before = i - base;  // tile entries k < before precede row i
#pragma unroll 8
    for (int k = 0; k < m; ++k) {
      const int v = tile[k];
      acc += (v < key) | ((v == key) & (k < before));
    }
    __syncthreads();
  }
  if (i < n) rank[i] = acc;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch.
// Requires 1 <= lanes <= 65535 and n >= 1 (the binding checks both).
extern "C" int sort_ranks_launch(const int* keys, int lanes, int n, int* rank,
                                 cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, lanes);
  sort_ranks_kernel<<<grid, kThreads, 0, stream>>>(keys, n, rank);
  return static_cast<int>(cudaGetLastError());
}
