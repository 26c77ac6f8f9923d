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
//     binding allocates. Each pass is three launches: count (each tile of
//     4096 keys counts its digits into per-warp shared histograms), scan
//     (one block per digit turns the (digit, tile)-major counts into
//     exclusive offsets and the digit's total) and scatter (each tile
//     stages its keys and payloads in shared memory with 16-byte loads,
//     ranks them stably by digit with __ballot_sync / __popc and
//     per-warp digit counts, reorders them in shared memory by digit, and
//     writes each digit's run to offset[digit][tile] + local rank). A pass
//     reads the keys twice and the payloads once and writes both: 20n
//     bytes, so the array goes through device memory about 5 times (the
//     network took about 80 at 2^22 keys). Stable, so its output equals a
//     stable sort's, payloads included.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kOneTile = 8192;  // pairs a single block sorts (power of 2)
constexpr int kOneTileThreads = 1024;
constexpr int kThreads = 256;  // radix blocks
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;  // keys per thread in a radix tile
constexpr int kTile = kThreads * kItems;
constexpr int kDigits = 256;
constexpr int kPasses = 4;
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ int digit_of(int key, int shift) {
  return static_cast<int>(
      ((static_cast<unsigned>(key) ^ 0x80000000u) >> shift) & 0xFFu);
}

// The lanes of the warp whose digit equals this lane's, among the lanes
// with `ok` (a multi-split: one ballot per digit bit). Every lane calls.
__device__ __forceinline__ unsigned same_digit_lanes(int d, bool ok) {
  unsigned peers = __ballot_sync(kFull, ok);
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool bit = (d >> b) & 1;
    const unsigned set = __ballot_sync(kFull, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

// Exclusive prefix sum of one int per thread over a kThreads block;
// `total` gets the block's sum. Every thread calls it.
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const int prefix = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return prefix + x - v;
}

// Copy `valid` ints of a tile into shared memory: 16-byte loads when the
// tile is full and the source aligned.
__device__ __forceinline__ void stage(const int* __restrict__ src, int* dst,
                                      int valid, bool vec) {
  if (vec && valid == kTile) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < kTile / 4; i += kThreads) d4[i] = __ldg(s4 + i);
  } else {
    for (int i = threadIdx.x; i < valid; i += kThreads) dst[i] = src[i];
  }
}

// counts[d * tiles + tile] = how many keys of the tile have digit d. Each
// warp counts into its own shared histogram (integer adds: the counts are
// exact in any order), so equal digits contend only within a warp.
__global__ void __launch_bounds__(kThreads)
    radix_count_kernel(const int* __restrict__ keys, long long n, int shift,
                       int tiles, bool vec, int* __restrict__ counts) {
  __shared__ int hist[kWarps][kDigits];
  for (int i = threadIdx.x; i < kWarps * kDigits; i += kThreads) {
    (&hist[0][0])[i] = 0;
  }
  __syncthreads();
  int* mine = hist[threadIdx.x >> 5];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int valid = static_cast<int>(n - base < kTile ? n - base : kTile);
  const int* src = keys + base;
  if (vec && valid == kTile) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
#pragma unroll
    for (int i = 0; i < kItems / 4; ++i) {
      const int4 v = __ldg(s4 + threadIdx.x + i * kThreads);
      atomicAdd(mine + digit_of(v.x, shift), 1);
      atomicAdd(mine + digit_of(v.y, shift), 1);
      atomicAdd(mine + digit_of(v.z, shift), 1);
      atomicAdd(mine + digit_of(v.w, shift), 1);
    }
  } else {
    for (int i = threadIdx.x; i < valid; i += kThreads) {
      atomicAdd(mine + digit_of(src[i], shift), 1);
    }
  }
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += hist[w][threadIdx.x];
  counts[static_cast<long long>(threadIdx.x) * tiles + blockIdx.x] = total;
}

// Block d: counts[d * tiles + t] becomes the number of digit-d keys in
// tiles before t; totals[d] the number in all tiles.
__global__ void __launch_bounds__(kThreads)
    radix_scan_kernel(int* __restrict__ counts, int tiles,
                      int* __restrict__ totals) {
  int* row = counts + static_cast<long long>(blockIdx.x) * tiles;
  int carry = 0;
  for (int start = 0; start < tiles; start += kThreads * 4) {
    int v[4];
    int sum = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int idx = start + threadIdx.x * 4 + j;
      v[j] = idx < tiles ? row[idx] : 0;
      sum += v[j];
    }
    int total;
    int run = carry + block_exclusive_scan(sum, &total);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int idx = start + threadIdx.x * 4 + j;
      if (idx < tiles) row[idx] = run;
      run += v[j];
    }
    carry += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// One stable pass: each tile's keys go, in their order, to
// digit_base[d] + offset[d][tile] + their rank among the tile's digit-d
// keys. Warp w ranks the tile's keys [512 w, 512 w + 512), 32 at a time
// in order, so ranks follow positions.
__global__ void __launch_bounds__(kThreads)
    radix_scatter_kernel(const int* __restrict__ keys_in,
                         const int* __restrict__ vals_in, long long n,
                         int shift, int tiles, bool vec,
                         const int* __restrict__ offsets,
                         const int* __restrict__ totals,
                         int* __restrict__ keys_out,
                         int* __restrict__ vals_out) {
  __shared__ __align__(16) int sk[kTile];
  __shared__ __align__(16) int sv[kTile];
  __shared__ int warp_digit[kWarps][kDigits];
  __shared__ int dest_base[kDigits];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int valid = static_cast<int>(n - base < kTile ? n - base : kTile);
  stage(keys_in + base, sk, valid, vec);
  stage(vals_in + base, sv, valid, vec);
  for (int i = threadIdx.x; i < kWarps * kDigits; i += kThreads) {
    (&warp_digit[0][0])[i] = 0;
  }
  __syncthreads();

  // rank each key among the earlier keys of its warp with its digit
  const unsigned lanes_below = (1u << lane) - 1;
  int key[kItems];
  int val[kItems];
  int rank[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int p = warp * (kTile / kWarps) + it * 32 + lane;
    const bool ok = p < valid;
    key[it] = ok ? sk[p] : 0;
    val[it] = ok ? sv[p] : 0;
    const int d = ok ? digit_of(key[it], shift) : 0;
    const unsigned peers = same_digit_lanes(d, ok);
    const int before = ok ? warp_digit[warp][d] : 0;
    rank[it] = before + __popc(peers & lanes_below);
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) {
      warp_digit[warp][d] = before + __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();

  // thread d: where digit d's keys of each warp start in the tile's
  // sorted order, and where the tile's run of digit d goes in the output
  const int d = threadIdx.x;
  int run = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_digit[w][d];
    warp_digit[w][d] = run;
    run += c;
  }
  int unused;
  const int tile_start = block_exclusive_scan(run, &unused);
  const int digit_start = block_exclusive_scan(totals[d], &unused);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) warp_digit[w][d] += tile_start;
  dest_base[d] = digit_start +
                 offsets[static_cast<long long>(d) * tiles + blockIdx.x] -
                 tile_start;
  __syncthreads();

  // reorder the tile by digit in shared memory, then write runs
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int p = warp * (kTile / kWarps) + it * 32 + lane;
    if (p < valid) {
      const int pos = warp_digit[warp][digit_of(key[it], shift)] + rank[it];
      sk[pos] = key[it];
      sv[pos] = val[it];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < valid; i += kThreads) {
    const int k = sk[i];
    const int dst = dest_base[digit_of(k, shift)] + i;
    keys_out[dst] = k;
    vals_out[dst] = sv[i];
  }
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

long long radix_tiles(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

// Ints of scratch a sort of n pairs needs: the (digit, tile) counts and
// the digit totals of the radix path; 0 within one tile, which also needs
// no scratch pair.
extern "C" long long bitonic_sort_scratch_ints(long long n) {
  return n <= kOneTile ? 0 : kDigits * (radix_tiles(n) + 1);
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
  const long long tiles = radix_tiles(n);
  int* counts = scratch;
  int* totals = scratch + kDigits * tiles;
  // pass 0: input -> tmp, 1: tmp -> out, 2: out -> tmp, 3: tmp -> out
  const int* src_k = keys_in;
  const int* src_v = vals_in;
  for (int pass = 0; pass < kPasses; ++pass) {
    int* dst_k = pass % 2 == 0 ? tmp_keys : keys_out;
    int* dst_v = pass % 2 == 0 ? tmp_vals : vals_out;
    const int shift = 8 * pass;
    const bool vec = aligned16(src_k, src_v);
    radix_count_kernel<<<tiles, kThreads, 0, stream>>>(
        src_k, n, shift, static_cast<int>(tiles), vec, counts);
    radix_scan_kernel<<<kDigits, kThreads, 0, stream>>>(
        counts, static_cast<int>(tiles), totals);
    radix_scatter_kernel<<<tiles, kThreads, 0, stream>>>(
        src_k, src_v, n, shift, static_cast<int>(tiles), vec, counts, totals,
        dst_k, dst_v);
    *device_launches += 3;
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src_k = dst_k;
    src_v = dst_v;
  }
  return static_cast<int>(cudaSuccess);
}
