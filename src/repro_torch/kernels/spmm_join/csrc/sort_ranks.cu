// Stable sorted position of every key (sort_ranks).
//
// Replaces the Pallas TPU kernel `_sort_ranks_kernel` in
// src/repro/kernels/spmm_join/kernel.py (launched by sort_ranks_pallas).
//
//   rank[i] = #{j : k_j < k_i} + #{j < i : k_j == k_i}
//
// Stacked form: `lanes` independent key rows, the lane in the grid's y
// dimension (one launch per kernel for a stacked batch; one lane for a
// single call).
//
// Bound on the H100: memory, n * 4 bytes in and n * 4 bytes out, beside
// the n log2 n compares of a comparison sort. The TPU kernel does n^2
// compares, every row against every key; a port of that (one thread per
// row, keys streamed through shared memory) put 16 blocks on 132 SMs at
// n = 4096 and grew quadratically past the sizes the engine's matrix joins
// can reach. The launcher picks one of two paths by n alone (never by the
// keys, so a plan program stays free of host syncs):
//
//   * n <= kCountMax: one launch spreads the compares over the card. Each
//     block owns kRows rows and holds their keys in registers; its threads
//     stride over all n keys together, each key loaded once per block and
//     compared with every row (keys before the block's rows count when
//     <=, keys after it when <, so the index test is needed only for the
//     block's own kRows keys). A warp's per-row counts meet in lane r by
//     a reduce-scatter of 31 shuffles (include/compare_fold.cuh), the
//     warps' in shared memory. No atomics, no memset: deterministic. At
//     n = 4096 that is 128 blocks, 16 loads a thread;
//   * n > kCountMax: the stable LSD radix sort of include/radix_sort.cuh
//     on (k ^ 0x80000000, index), 4 passes of count / scan / scatter, 12
//     device launches. The first pass takes each key's index as its
//     payload without reading one; the last writes rank[index] = its
//     sorted position instead of the pair. O(n) work a pass; the scratch
//     pairs and histograms are the binding's (torch.empty, per lane).
#include <cuda_runtime.h>

#include "compare_fold.cuh"
#include "radix_sort.cuh"

namespace {

// Largest n on the compare path, where its time meets the radix path's:
// chip_smoke.py times each path on its own side of it (2^14 and kCountMax
// keys on the compare path, kCountMax + 1 and 2^15 on the radix path;
// readings in PERF.md).
constexpr int kCountMax = 20480;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
using compare::fold;
using compare::kRows;

__global__ void __launch_bounds__(kThreads)
    rank_compare_kernel(const int* __restrict__ keys, int n,
                        int* __restrict__ rank) {
  __shared__ int own[kRows];
  __shared__ int part[kWarps][kRows];
  const long long lane_base = static_cast<long long>(blockIdx.y) * n;
  keys += lane_base;
  rank += lane_base;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kRows;
  const int rows = min(kRows, n - base);
  if (threadIdx.x < kRows) own[threadIdx.x] = lane < rows ? keys[base + lane] : 0;
  __syncthreads();
  int key[kRows];
  int acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    key[r] = own[r];
    acc[r] = 0;
  }
  // keys before the block's rows precede each row when <=
#pragma unroll 4
  for (int j = threadIdx.x; j < base; j += kThreads) {
    const int v = __ldg(keys + j);
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] += v <= key[r];
  }
  // the block's own keys: the index decides among equal keys
  if (threadIdx.x < rows) {
    const int v = own[threadIdx.x];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      acc[r] += (v < key[r]) | ((v == key[r]) & (static_cast<int>(threadIdx.x) < r));
    }
  }
  // keys after them precede a row when <
#pragma unroll 4
  for (int j = base + rows + threadIdx.x; j < n; j += kThreads) {
    const int v = __ldg(keys + j);
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] += v < key[r];
  }
  fold<kRows / 2>(acc, lane);  // lane r: the warp's count of row r
  part[warp][lane] = acc[0];
  __syncthreads();
  if (threadIdx.x < rows) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += part[w][threadIdx.x];
    rank[base + threadIdx.x] = sum;
  }
}


}  // namespace

// Ints of scratch the launcher needs for `lanes` rows of n keys: on the
// radix path (n > kCountMax) two (key, index) pairs per lane and the
// histograms; 0 on the compare path.
extern "C" long long sort_ranks_scratch_ints(int lanes, int n) {
  if (n <= kCountMax) return 0;
  return 4LL * lanes * n + radix::scratch_ints(n, lanes);
}

// Ranks of `lanes` rows of n keys into `rank`, on `stream`, every launch in
// order; `scratch` holds sort_ranks_scratch_ints(lanes, n) ints.
// Returns the first cudaGetLastError() that is not cudaSuccess, else
// cudaSuccess, and writes how many device launches it made. Requires
// 1 <= lanes <= 65535 and n >= 1 (the binding checks both).
extern "C" int sort_ranks_launch(const int* keys, int lanes, int n, int* rank,
                                 int* scratch, int* device_launches,
                                 cudaStream_t stream) {
  *device_launches = 0;
  if (n <= kCountMax) {
    const dim3 grid((n + kRows - 1) / kRows, lanes);
    rank_compare_kernel<<<grid, kThreads, 0, stream>>>(keys, n, rank);
    *device_launches = 1;
    return static_cast<int>(cudaGetLastError());
  }
  const long long per = static_cast<long long>(lanes) * n;
  int* a_k = scratch;
  int* a_v = a_k + per;
  int* b_k = a_v + per;
  int* b_v = b_k + per;
  const int tiles = static_cast<int>(radix::tiles_of(n));
  int* counts = b_v + per;
  int* totals = counts + static_cast<long long>(lanes) * radix::kDigits * tiles;
  const dim3 tile_grid(tiles, lanes);
  const dim3 digit_grid(radix::kDigits, lanes);
  // pass 0: keys (index payloads) -> a, 1: a -> b, 2: b -> a, 3: a -> rank
  const int* src_k = keys;
  const int* src_v = nullptr;
  for (int pass = 0; pass < radix::kPasses; ++pass) {
    int* dst_k = pass % 2 == 0 ? a_k : b_k;
    int* dst_v = pass % 2 == 0 ? a_v : b_v;
    const int shift = 8 * pass;
    // lane rows stay 16-byte aligned only when n is a multiple of 4
    const bool vec = radix::aligned16(src_k, src_v) && (lanes == 1 || n % 4 == 0);
    radix::count_kernel<<<tile_grid, radix::kThreads, 0, stream>>>(
        src_k, n, shift, tiles, vec, counts);
    radix::scan_kernel<<<digit_grid, radix::kThreads, 0, stream>>>(
        counts, tiles, totals);
    if (pass == 0) {
      radix::scatter_kernel<true, false><<<tile_grid, radix::kThreads, 0, stream>>>(
          src_k, nullptr, n, shift, tiles, vec, counts, totals, dst_k, dst_v);
    } else if (pass < radix::kPasses - 1) {
      radix::scatter_kernel<false, false><<<tile_grid, radix::kThreads, 0, stream>>>(
          src_k, src_v, n, shift, tiles, vec, counts, totals, dst_k, dst_v);
    } else {
      radix::scatter_kernel<false, true><<<tile_grid, radix::kThreads, 0, stream>>>(
          src_k, src_v, n, shift, tiles, vec, counts, totals, nullptr, rank);
    }
    *device_launches += 3;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src_k = dst_k;
    src_v = dst_v;
  }
  return static_cast<int>(cudaSuccess);
}
