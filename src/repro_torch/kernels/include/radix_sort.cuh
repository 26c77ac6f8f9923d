// The passes of a stable least-significant-digit radix sort of int32 keys
// with an int32 payload, shared by csrc/bitonic_sort.cu (sort_pairs above
// one tile), csrc/sort_ranks.cu (ranks above its threshold) and
// csrc/match_layout.cu (both sides of its sort-and-search path).
//
// Four passes of 8-bit digits of k ^ 0x80000000 (signed order as unsigned
// order); each pass is three launches over tiles of kTile keys:
//
//   count   — each tile counts its digits into per-warp shared histograms
//             (integer adds: exact in any order) and writes them
//             (digit, tile)-major;
//   scan    — one block per digit turns its row of counts into exclusive
//             offsets and the digit's total;
//   scatter — each tile stages its keys and payloads in shared memory with
//             16-byte loads, ranks them stably by digit (warp w takes its
//             slice 32 keys at a time in order; the lanes with an equal
//             digit come from 8 __ballot_sync bit splits, the earlier ones
//             from per-warp digit counts), reorders them by digit in shared
//             memory and writes each digit's run to its offset.
//
// A pass reads the keys twice and the payloads once and writes both: 20n
// bytes. Stacked form: every launch takes `lanes` independent rows in the
// grid's y dimension (keys and payloads at lane * n, counts at
// lane * kDigits * tiles, totals at lane * kDigits). Two variants of the
// scatter serve sort_ranks: the first pass takes each key's index as its
// payload instead of reading one, and the last writes rank[payload] = the
// key's sorted position instead of the pair, so no fifth pass is needed.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {
namespace radix {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;  // keys per thread in a tile
constexpr int kTile = kThreads * kItems;
constexpr int kDigits = 256;
constexpr int kPasses = 4;
constexpr int kLaunches = 3 * kPasses;  // device launches of one sort
constexpr unsigned kFull = 0xffffffffu;

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
// warp counts into its own shared histogram, so equal digits contend only
// within a warp.
__global__ void __launch_bounds__(kThreads)
    count_kernel(const int* __restrict__ keys, long long n, int shift,
                 int tiles, bool vec, int* __restrict__ counts) {
  __shared__ int hist[kWarps][kDigits];
  keys += blockIdx.y * n;
  counts += static_cast<long long>(blockIdx.y) * kDigits * tiles;
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
    scan_kernel(int* __restrict__ counts, int tiles, int* __restrict__ totals) {
  int* row = counts + (static_cast<long long>(blockIdx.y) * kDigits +
                       blockIdx.x) * tiles;
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
  if (threadIdx.x == 0) totals[blockIdx.y * kDigits + blockIdx.x] = carry;
}

// One stable pass: each tile's keys go, in their order, to
// digit_base[d] + offset[d][tile] + their rank among the tile's digit-d
// keys. Warp w ranks the tile's keys [512 w, 512 w + 512), 32 at a time
// in order, so ranks follow positions.
//
// kIndexIn: the payload of the key at p is p (vals_in is not read).
// kRankOut: vals_out[payload] = the key's position (keys_out is not
// written), in place of writing the pair.
template <bool kIndexIn, bool kRankOut>
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const int* __restrict__ keys_in,
                   const int* __restrict__ vals_in, long long n, int shift,
                   int tiles, bool vec, const int* __restrict__ offsets,
                   const int* __restrict__ totals, int* __restrict__ keys_out,
                   int* __restrict__ vals_out) {
  __shared__ __align__(16) int sk[kTile];
  __shared__ __align__(16) int sv[kTile];
  __shared__ int warp_digit[kWarps][kDigits];
  __shared__ int dest_base[kDigits];
  const long long lane_base = blockIdx.y * n;
  keys_in += lane_base;
  if (!kIndexIn) vals_in += lane_base;
  if (!kRankOut) keys_out += lane_base;
  vals_out += lane_base;
  offsets += static_cast<long long>(blockIdx.y) * kDigits * tiles;
  totals += blockIdx.y * kDigits;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int valid = static_cast<int>(n - base < kTile ? n - base : kTile);
  stage(keys_in + base, sk, valid, vec);
  if (!kIndexIn) stage(vals_in + base, sv, valid, vec);
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
    if (kIndexIn) {
      val[it] = static_cast<int>(base) + p;
    } else {
      val[it] = ok ? sv[p] : 0;
    }
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

  if (kRankOut) {  // the position is the output: no reorder needed
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int p = warp * (kTile / kWarps) + it * 32 + lane;
      if (p < valid) {
        const int dg = digit_of(key[it], shift);
        vals_out[val[it]] = dest_base[dg] + warp_digit[warp][dg] + rank[it];
      }
    }
  } else {  // reorder the tile by digit in shared memory, then write runs
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
}

inline bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

inline long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

// Ints of scratch for the counts and totals of `lanes` sorts of n keys.
inline long long scratch_ints(long long n, int lanes) {
  return static_cast<long long>(lanes) * kDigits * (tiles_of(n) + 1);
}

}  // namespace radix
}  // namespace
