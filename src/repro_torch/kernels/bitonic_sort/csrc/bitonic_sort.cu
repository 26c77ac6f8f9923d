// Sort of int32 (key, payload) pairs by key, ascending.
//
// Replaces the Pallas TPU kernel `_sort_kernel` + `_compare_exchange` in
// src/repro/kernels/bitonic_sort/kernel.py (launched by bitonic_sort_pairs).
//
// The TPU kernel holds a power-of-two array (at most 2^19 pairs) in one
// VMEM block and unrolls a bitonic network over it; its wrapper pads with
// INT32_MAX keys and hands longer arrays to XLA's sort. A Hopper block has
// at most 227 KB of shared memory, and a network over more than that must
// run its long-distance steps through device memory, one pass each.
//
// Bound on the H100: memory. The function reads 8n bytes and writes 8n:
// 16n bytes over 3.35 TB/s. So the design takes the fewest passes over
// device memory that it can:
//
//   * n up to one tile (8192 pairs, 64 KB of dynamic shared memory): one
//     launch sorts the whole array in one block with the all-ascending
//     bitonic network over m = n rounded up to a power of two. Stage k
//     starts with a "flip" step comparing i with its mirror in the k-block,
//     then half-cleaner steps at distances k/4 .. 1; every
//     compare-exchange puts the smaller key at the lower index. Elements
//     past n are virtual +infinity: a pair whose upper index is >= n is
//     left alone, so nothing is padded and a real INT32_MAX key keeps its
//     own payload. This path is not stable. One block runs on one SM, and
//     its steps grow as log2(m)^2: at 16384 pairs it took 0.19 ms on the
//     H100 against 0.14 ms for the radix path at 16385, so the tile stops
//     at 8192 although 16384 pairs would fit;
//   * n above one tile: a stable least-significant-digit radix sort, four
//     passes of 8-bit digits of k ^ 0x80000000 (signed order as unsigned
//     order), ping-ponging between the outputs and a scratch pair the
//     binding allocates. Each pass is three launches (count, scan,
//     scatter; include/radix_sort.cuh, shared with sort_ranks.cu), 12 in
//     all. A pass reads the keys twice and the payloads once and writes
//     both: 20n bytes, so the array goes through device memory about 5
//     times (the network took about 80 at 2^22 keys). Stable, so its
//     output equals a stable sort's, payloads included.
#include <cuda_runtime.h>

#include "radix_sort.cuh"

namespace {

constexpr int kOneTile = 8192;  // pairs a single block sorts (power of 2)
constexpr int kOneTileThreads = 1024;

__device__ __forceinline__ void compare_exchange(int* keys, int* vals, int i,
                                                 int l) {
  const int ka = keys[i];
  const int kb = keys[l];
  if (ka > kb) {
    keys[i] = kb;
    keys[l] = ka;
    const int va = vals[i];
    vals[i] = vals[l];
    vals[l] = va;
  }
}

// The whole array (n <= m <= kOneTile) in one block's shared memory.
__global__ void __launch_bounds__(kOneTileThreads)
    sort_one_tile_kernel(const int* __restrict__ keys_in,
                         const int* __restrict__ vals_in, int n, int m,
                         int* __restrict__ keys_out,
                         int* __restrict__ vals_out) {
  extern __shared__ int smem[];
  int* sk = smem;
  int* sv = smem + m;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    sk[e] = keys_in[e];
    sv[e] = vals_in[e];
  }
  __syncthreads();
  const int half = m >> 1;
  for (int k = 2; k <= m; k <<= 1) {
    const int h = k >> 1;
    for (int t = threadIdx.x; t < half; t += blockDim.x) {  // flip step
      const int o = t & (h - 1);
      const int start = (t - o) << 1;
      const int l = start + k - 1 - o;
      if (l < n) compare_exchange(sk, sv, start + o, l);
    }
    __syncthreads();
    for (int j = k >> 2; j >= 1; j >>= 1) {  // half-cleaners
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int o = t & (j - 1);
        const int i = ((t - o) << 1) + o;
        if (i + j < n) compare_exchange(sk, sv, i, i + j);
      }
      __syncthreads();
    }
  }
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    keys_out[e] = sk[e];
    vals_out[e] = sv[e];
  }
}

}  // namespace

// Ints of scratch a sort of n pairs needs: the (digit, tile) counts and
// the digit totals of the radix path; 0 within one tile, which also needs
// no scratch pair.
extern "C" long long bitonic_sort_scratch_ints(long long n) {
  return n <= kOneTile ? 0 : radix::scratch_ints(n, 1);
}

// Sort (keys_in, vals_in) into (keys_out, vals_out) on `stream`, every
// launch in order; `tmp_keys`, `tmp_vals` (n ints each) and `scratch`
// (bitonic_sort_scratch_ints(n) ints) are used above one tile. Returns the
// first cudaGetLastError() that is not cudaSuccess, else cudaSuccess, and
// writes how many device launches it made. Requires 1 <= n <= 2^30 (the
// binding checks it).
extern "C" int bitonic_sort_launch(const int* keys_in, const int* vals_in,
                                   long long n, int* keys_out, int* vals_out,
                                   int* tmp_keys, int* tmp_vals, int* scratch,
                                   int* device_launches, cudaStream_t stream) {
  *device_launches = 0;
  cudaError_t err;
  if (n <= kOneTile) {
    int m = 2;
    while (m < n) m <<= 1;
    const int bytes = 2 * m * static_cast<int>(sizeof(int));
    if (bytes > 48 * 1024) {  // above 48 KB a kernel must opt in
      err = cudaFuncSetAttribute(sort_one_tile_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int threads = m / 2 < kOneTileThreads ? m / 2 : kOneTileThreads;
    sort_one_tile_kernel<<<1, threads, bytes, stream>>>(
        keys_in, vals_in, static_cast<int>(n), m, keys_out, vals_out);
    *device_launches = 1;
    return static_cast<int>(cudaGetLastError());
  }
  const int tiles = static_cast<int>(radix::tiles_of(n));
  int* counts = scratch;
  int* totals = scratch + static_cast<long long>(radix::kDigits) * tiles;
  // pass 0: input -> tmp, 1: tmp -> out, 2: out -> tmp, 3: tmp -> out
  const int* src_k = keys_in;
  const int* src_v = vals_in;
  for (int pass = 0; pass < radix::kPasses; ++pass) {
    int* dst_k = pass % 2 == 0 ? tmp_keys : keys_out;
    int* dst_v = pass % 2 == 0 ? tmp_vals : vals_out;
    const int shift = 8 * pass;
    const bool vec = radix::aligned16(src_k, src_v);
    radix::count_kernel<<<tiles, radix::kThreads, 0, stream>>>(
        src_k, n, shift, tiles, vec, counts);
    radix::scan_kernel<<<radix::kDigits, radix::kThreads, 0, stream>>>(
        counts, tiles, totals);
    radix::scatter_kernel<false, false><<<tiles, radix::kThreads, 0, stream>>>(
        src_k, src_v, n, shift, tiles, vec, counts, totals, dst_k, dst_v);
    *device_launches += 3;
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src_k = dst_k;
    src_v = dst_v;
  }
  return static_cast<int>(cudaSuccess);
}
