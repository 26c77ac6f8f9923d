// The matrix join's output layout (match_layout).
//
// Replaces the Pallas TPU kernel `_match_layout_kernel` in
// src/repro/kernels/spmm_join/kernel.py:29 (called by match_layout_pallas
// at :84).
//
// With E[i,j] = [lk_i == rk_j]:
//   counts[i] = sum_j E[i,j]             first[i] = #{j : rk_j < lk_i}
//   b[i]      = sum_j E[i,j] * #{i' < i : lk_i' == rk_j}
//   cl[j]     = sum_i E[i,j]
//
// The TPU kernel carries the column sums of E from one grid step to the
// next in a revisited output block; that is sound only because TPU grid
// steps run in order, and CUDA blocks do not. The carry is dropped here:
// E[i,j] = 1 implies rk_j == lk_i, so b[i] = counts[i] * occ[i] with
// occ[i] = #{i' < i : lk_i' == lk_i}, and every output is an independent
// per-row count. b is that product in unsigned arithmetic: it wraps mod
// 2^32 exactly as the reference's int32 sum does. Every output is exact,
// bit-equal to the TPU kernel and the jnp reference for every key,
// sentinels and INT32_MIN included.
//
// Bound on the H100. The function needs the keys read once and four
// int32 outputs written once, (4 n_l + 2 n_r) * 4 bytes, and a sort of
// both sides: memory-bound. The TPU kernel's dense compares are
// 2 n_l n_r (eq and lt per pair) + n_l^2 / 2 (occ, quadratic in the left
// side alone), int32 compare-and-add on the CUDA cores; the optimizer
// caps only the product of the estimated sides, and the matrix backend
// forced by the caller has no cap, so those compares can reach 10^12.
// The launcher picks one of two paths from (n_l, n_r) alone, never from
// the keys, so a plan program stays free of host syncs (the lanes take
// the same path):
//
//   * 2 n_l n_r + n_l^2 / 2 <= kCompareMax: the compare path, one device
//     launch, the design of sort_ranks' compare path. One grid holds the
//     row blocks and the column blocks, the stacked lanes in grid y. A row
//     block holds 32 left keys in registers, one per lane; its 256 threads
//     stride together over the right keys (eq, lt), every key loaded once
//     per block (16-byte loads) and compared with all 32 rows, then over
//     the left keys before the block's end (eq; the index test only on the
//     block's own 32 keys), a pass it skips when none of its rows matched
//     (b = 0 there). A column block does the same for 32 right keys over
//     all the left keys (cl). A warp's per-row counts meet in lane r by
//     the reduce-scatter of 31 shuffles (include/compare_fold.cuh), the
//     warps' in shared memory. No atomics, no memset: deterministic. At
//     4096 x 1024 that is 160 blocks. A partial block stops at its last
//     row. Up to 256 left keys, a column block takes 256 right keys
//     instead, a thread each, against the left keys staged in shared
//     memory: 8 times fewer blocks and no reduce where a block of 32
//     would have little to compare (4 x 2^20: 32,768 blocks of 4).
//   * above it, the sort-and-search path, O((n_l + n_r) log) work in 25
//     device launches: both sides sorted stably on (key, index) by the
//     4 radix passes of include/radix_sort.cuh (12 launches each), then
//     one search kernel over the sorted positions. Left position p, key k,
//     row i: first[i] = lower_bound(rk_sorted, k), counts[i] =
//     upper_bound(rk_sorted, k) - first[i], occ[i] = p - lower_bound(
//     lk_sorted, k) (the sort is stable, so the equal keys before p are
//     row i's earlier equal rows). Right position q, key k, row j: cl[j]
//     = upper_bound(lk_sorted, k) - lower_bound(lk_sorted, k). A warp
//     takes 32 neighbouring sorted keys, so its searches walk nearly one
//     path and their loads meet (in row order every thread walks its own
//     path); the outputs are scattered to the rows. The scratch (two
//     (key, index) pairs per row of each side and the histograms) is the
//     binding's, sized by match_layout_scratch_ints; the kernels allocate
//     nothing.
//
// What bounds each path: the compare path, its int32 compares on the
// CUDA cores and, at a handful of left rows, the one row block that
// streams all the right keys on one SM;
// the sort-and-search path, 25 launches in turn at small sizes, the radix
// passes' bytes (20 bytes a key a pass) and the searches' dependent loads
// at large ones. kCompareMax sits where the two meet.
#include <cuda_runtime.h>

#include <cstdint>

#include "compare_fold.cuh"
#include "radix_sort.cuh"

namespace {

// Largest compare count 2 n_l n_r + n_l^2 / 2 on the compare path, where
// its time meets the sort-and-search path's: chip_smoke.py times each
// path on its own side of it (readings in PERF.md).
constexpr long long kCompareMax = 1LL << 29;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
using compare::fold;
using compare::kRows;

long long compares_of(int n_l, int n_r) {
  return 2LL * n_l * n_r + static_cast<long long>(n_l) * n_l / 2;
}

bool sorted_path(int n_l, int n_r) { return compares_of(n_l, n_r) > kCompareMax; }

// Right keys a column block lays out: a thread each up to kThreads left
// keys, else kRows held in registers.
__host__ __device__ inline int col_keys_of(int n_l) {
  return n_l <= kThreads ? kThreads : kRows;
}

// visit(v) for every key v of keys[0, n), the block's threads together:
// a scalar head up to a 16-byte boundary, 16-byte loads, a scalar tail.
template <typename Visit>
__device__ __forceinline__ void for_each_key(const int* __restrict__ keys,
                                             int n, Visit&& visit) {
  const int misaligned =
      static_cast<int>(reinterpret_cast<uintptr_t>(keys) & 15) >> 2;
  const int head = min(n, (4 - misaligned) & 3);
  if (static_cast<int>(threadIdx.x) < head) visit(__ldg(keys + threadIdx.x));
  const int4* body = reinterpret_cast<const int4*>(keys + head);
  const int quads = (n - head) >> 2;
#pragma unroll 2
  for (int q = threadIdx.x; q < quads; q += kThreads) {
    const int4 v = __ldg(body + q);
    visit(v.x);
    visit(v.y);
    visit(v.z);
    visit(v.w);
  }
  const int tail = head + 4 * quads + threadIdx.x;
  if (tail < n) visit(__ldg(keys + tail));
}

// The block's sum of each row's warp counts (lane r of warp w holds
// part[w][r]), read by thread r < rows.
__device__ __forceinline__ int rows_sum(const int (&part)[kWarps][kRows]) {
  int sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) sum += part[w][threadIdx.x];
  return sum;
}

// A row block: counts, first and b of the left rows [base, base + rows),
// whose keys are in own[]. kFull: rows == kRows (a partial block stops
// at its last row).
template <bool kFull>
__device__ __forceinline__ void layout_rows(
    const int* __restrict__ lk, const int* __restrict__ rk, int n_r,
    int base, int rows, const int (&own)[kRows], int (&part)[2][kWarps][kRows],
    int* __restrict__ counts, int* __restrict__ first, int* __restrict__ b) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int key[kRows];
  int eq[kRows];
  int lt[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    key[r] = own[r];
    eq[r] = 0;
    lt[r] = 0;
  }
  for_each_key(rk, n_r, [&](int v) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (!kFull && r == rows) break;
      eq[r] += v == key[r];
      lt[r] += v < key[r];
    }
  });
  fold<kRows / 2>(eq, lane);  // lane r: the warp's counts of row r
  fold<kRows / 2>(lt, lane);
  part[0][warp][lane] = eq[0];
  part[1][warp][lane] = lt[0];
  __syncthreads();
  int c = 0;
  if (threadIdx.x < rows) {
    c = rows_sum(part[0]);
    counts[base + threadIdx.x] = c;
    first[base + threadIdx.x] = rows_sum(part[1]);
  }
  // b = counts * occ: nothing to count when no row of the block matched
  // (the barrier also ends every read of part before it is reused)
  if (!__syncthreads_or(c > 0)) {
    if (threadIdx.x < rows) b[base + threadIdx.x] = 0;
    return;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) eq[r] = 0;
  // left keys before the block's rows: every equal one is earlier
  for_each_key(lk, base, [&](int v) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (!kFull && r == rows) break;
      eq[r] += v == key[r];
    }
  });
  // the block's own keys: the index decides
  if (threadIdx.x < rows) {
    const int v = own[threadIdx.x];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (!kFull && r == rows) break;
      eq[r] += (v == key[r]) & (static_cast<int>(threadIdx.x) < r);
    }
  }
  fold<kRows / 2>(eq, lane);
  part[0][warp][lane] = eq[0];
  __syncthreads();
  if (threadIdx.x < rows) {
    const unsigned occ = static_cast<unsigned>(rows_sum(part[0]));
    b[base + threadIdx.x] = static_cast<int>(static_cast<unsigned>(c) * occ);
  }
}

// A column block of kRows right keys: cl of the right rows [base, base +
// cols), whose keys are in own[].
template <bool kFull>
__device__ __forceinline__ void layout_cols(
    const int* __restrict__ lk, int n_l, int base, int cols,
    const int (&own)[kRows], int (&part)[2][kWarps][kRows],
    int* __restrict__ cl) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int key[kRows];
  int eq[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    key[r] = own[r];
    eq[r] = 0;
  }
  for_each_key(lk, n_l, [&](int v) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (!kFull && r == cols) break;
      eq[r] += v == key[r];
    }
  });
  fold<kRows / 2>(eq, lane);
  part[0][warp][lane] = eq[0];
  __syncthreads();
  if (threadIdx.x < cols) cl[base + threadIdx.x] = rows_sum(part[0]);
}

// The compare path: blocks [0, row_blocks) are row blocks, the rest
// column blocks; grid y is the lane.
__global__ void __launch_bounds__(kThreads, 2)
    layout_compare_kernel(const int* __restrict__ lk,
                          const int* __restrict__ rk, int n_l, int n_r,
                          int row_blocks, int* __restrict__ counts,
                          int* __restrict__ first, int* __restrict__ b,
                          int* __restrict__ cl) {
  __shared__ int own[kRows];
  __shared__ int part[2][kWarps][kRows];
  __shared__ int left[kThreads];
  const long long lane_l = static_cast<long long>(blockIdx.y) * n_l;
  const long long lane_r = static_cast<long long>(blockIdx.y) * n_r;
  lk += lane_l;
  rk += lane_r;
  if (static_cast<int>(blockIdx.x) < row_blocks) {
    const int base = blockIdx.x * kRows;
    const int rows = min(kRows, n_l - base);
    if (threadIdx.x < kRows) {
      own[threadIdx.x] = static_cast<int>(threadIdx.x) < rows
                             ? lk[base + threadIdx.x] : 0;
    }
    __syncthreads();
    if (rows == kRows) {
      layout_rows<true>(lk, rk, n_r, base, rows, own, part, counts + lane_l,
                        first + lane_l, b + lane_l);
    } else {
      layout_rows<false>(lk, rk, n_r, base, rows, own, part, counts + lane_l,
                         first + lane_l, b + lane_l);
    }
    return;
  }
  const int width = col_keys_of(n_l);
  const int base = (blockIdx.x - row_blocks) * width;
  const int cols = min(width, n_r - base);
  if (width == kThreads) {  // a right key a thread, the left keys staged
    if (static_cast<int>(threadIdx.x) < n_l) left[threadIdx.x] = lk[threadIdx.x];
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < cols) {
      const int key = rk[base + threadIdx.x];
      int c = 0;
      for (int i = 0; i < n_l; ++i) c += left[i] == key;
      cl[lane_r + base + threadIdx.x] = c;
    }
    return;
  }
  if (threadIdx.x < kRows) {
    own[threadIdx.x] = static_cast<int>(threadIdx.x) < cols
                           ? rk[base + threadIdx.x] : 0;
  }
  __syncthreads();
  if (cols == kRows) {
    layout_cols<true>(lk, n_l, base, cols, own, part, cl + lane_r);
  } else {
    layout_cols<false>(lk, n_l, base, cols, own, part, cl + lane_r);
  }
}

// First index in [lo, hi) whose key is >= key (kUpper: > key), else hi.
template <bool kUpper>
__device__ __forceinline__ int bound_of(const int* __restrict__ a, int lo,
                                        int hi, int key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    const int v = __ldg(a + mid);
    if (kUpper ? v <= key : v < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The sort-and-search path's last launch, over the sorted positions:
// blocks [0, left_blocks) take a left position a thread, the rest a right
// position; grid y is the lane. *_row holds each sorted key's row.
__global__ void __launch_bounds__(kThreads)
    layout_search_kernel(const int* __restrict__ lk_sorted,
                         const int* __restrict__ lk_row,
                         const int* __restrict__ rk_sorted,
                         const int* __restrict__ rk_row, int n_l, int n_r,
                         int left_blocks, int* __restrict__ counts,
                         int* __restrict__ first, int* __restrict__ b,
                         int* __restrict__ cl) {
  const long long lane_l = static_cast<long long>(blockIdx.y) * n_l;
  const long long lane_r = static_cast<long long>(blockIdx.y) * n_r;
  lk_sorted += lane_l;
  rk_sorted += lane_r;
  if (static_cast<int>(blockIdx.x) < left_blocks) {
    const int p = blockIdx.x * kThreads + threadIdx.x;
    if (p >= n_l) return;
    const int key = lk_sorted[p];
    const int f = bound_of<false>(rk_sorted, 0, n_r, key);
    const unsigned c = bound_of<true>(rk_sorted, f, n_r, key) - f;
    const unsigned occ = p - bound_of<false>(lk_sorted, 0, p, key);
    const long long i = lane_l + lk_row[lane_l + p];
    counts[i] = static_cast<int>(c);
    first[i] = f;
    b[i] = static_cast<int>(c * occ);
  } else {
    const int q = (blockIdx.x - left_blocks) * kThreads + threadIdx.x;
    if (q >= n_r) return;
    const int key = rk_sorted[q];
    const int lo = bound_of<false>(lk_sorted, 0, n_l, key);
    cl[lane_r + rk_row[lane_r + q]] = bound_of<true>(lk_sorted, lo, n_l, key) - lo;
  }
}

// Stable sort of `lanes` rows of n keys on (key, index): 4 radix passes
// through the pairs (a_k, a_v), ending in (b_k, b_v): the sorted keys and
// each one's row. hist holds radix::scratch_ints(n, lanes) ints.
cudaError_t sort_side(const int* keys, int lanes, int n, int* a_k, int* a_v,
                      int* b_k, int* b_v, int* hist, cudaStream_t stream) {
  const int tiles = static_cast<int>(radix::tiles_of(n));
  int* counts = hist;
  int* totals = counts + static_cast<long long>(lanes) * radix::kDigits * tiles;
  const dim3 tile_grid(tiles, lanes);
  const dim3 digit_grid(radix::kDigits, lanes);
  // pass 0: keys (index payloads) -> a, 1: a -> b, 2: b -> a, 3: a -> b
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
    } else {
      radix::scatter_kernel<false, false><<<tile_grid, radix::kThreads, 0, stream>>>(
          src_k, src_v, n, shift, tiles, vec, counts, totals, dst_k, dst_v);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src_k = dst_k;
    src_v = dst_v;
  }
  return cudaSuccess;
}

}  // namespace

// Ints of scratch the launcher needs for `lanes` pairs of n_l left and n_r
// right keys: on the sort-and-search path two (key, index) pairs per row
// of each side and the histograms (shared by the two sorts, which run in
// turn); 0 on the compare path.
extern "C" long long match_layout_scratch_ints(int lanes, int n_l, int n_r) {
  if (!sorted_path(n_l, n_r)) return 0;
  return 4LL * lanes * (static_cast<long long>(n_l) + n_r) +
         radix::scratch_ints(n_l > n_r ? n_l : n_r, lanes);
}

// The layout of `lanes` pairs (lk, rk) into counts, first, b and cl, on
// `stream`, every launch in order; `scratch` holds
// match_layout_scratch_ints(lanes, n_l, n_r) ints. Returns the first
// cudaGetLastError() that is not cudaSuccess, else cudaSuccess, and
// writes how many device launches it made. Requires 1 <= lanes <= 65535,
// n_l >= 1 and n_r >= 1 (the binding checks all three).
extern "C" int match_layout_launch(const int* lk, const int* rk, int lanes,
                                   int n_l, int n_r, int* counts, int* first,
                                   int* b, int* cl, int* scratch,
                                   int* device_launches, cudaStream_t stream) {
  *device_launches = 0;
  if (!sorted_path(n_l, n_r)) {
    const int row_blocks = (n_l + kRows - 1) / kRows;
    const int width = col_keys_of(n_l);
    const dim3 grid(row_blocks + (n_r + width - 1) / width, lanes);
    layout_compare_kernel<<<grid, kThreads, 0, stream>>>(
        lk, rk, n_l, n_r, row_blocks, counts, first, b, cl);
    *device_launches = 1;
    return static_cast<int>(cudaGetLastError());
  }
  const long long per_l = static_cast<long long>(lanes) * n_l;
  const long long per_r = static_cast<long long>(lanes) * n_r;
  int* l_ak = scratch;
  int* l_av = l_ak + per_l;
  int* lk_sorted = l_av + per_l;
  int* lk_row = lk_sorted + per_l;
  int* r_ak = lk_row + per_l;
  int* r_av = r_ak + per_r;
  int* rk_sorted = r_av + per_r;
  int* rk_row = rk_sorted + per_r;
  int* hist = rk_row + per_r;
  cudaError_t err = sort_side(lk, lanes, n_l, l_ak, l_av, lk_sorted, lk_row,
                              hist, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  *device_launches += radix::kLaunches;
  err = sort_side(rk, lanes, n_r, r_ak, r_av, rk_sorted, rk_row, hist, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  *device_launches += radix::kLaunches;
  const int left_blocks = (n_l + kThreads - 1) / kThreads;
  const dim3 grid(left_blocks + (n_r + kThreads - 1) / kThreads, lanes);
  layout_search_kernel<<<grid, kThreads, 0, stream>>>(
      lk_sorted, lk_row, rk_sorted, rk_row, n_l, n_r, left_blocks, counts,
      first, b, cl);
  *device_launches += 1;
  return static_cast<int>(cudaGetLastError());
}
