// Bitonic sort of int32 (key, payload) pairs by key, ascending; not stable.
//
// Replaces the Pallas TPU kernel `_sort_kernel` + `_compare_exchange` in
// src/repro/kernels/bitonic_sort/kernel.py (launched by bitonic_sort_pairs).
//
// The TPU kernel holds a power-of-two array (at most 2^19 pairs) in one
// VMEM block and unrolls every pass; its wrapper pads with INT32_MAX keys
// and hands longer arrays to XLA's sort. A Hopper block has at most 227 KB
// of shared memory, so the design here splits the passes by distance:
//
//   * the network is the all-ascending form: stage k (block size k) starts
//     with a "flip" step comparing i with its mirror in the k-block
//     (block_start + k - 1 - offset), then half-cleaner steps at distances
//     k/4 .. 1; every compare-exchange puts the smaller key at the lower
//     index. Elements past n are virtual +infinity: a pair whose upper
//     index is >= n is left alone, so real elements never leave [0, n) and
//     any n is served without padding buffers (a real INT32_MAX key keeps
//     its own payload, which padding with INT32_MAX cannot promise);
//   * steps at distance < kTile run in shared memory, kTile pairs per block
//     (kTile/2 threads, one compare-exchange each per step): one kernel
//     sorts every tile (all stages up to kTile), and one finishes each
//     later stage below the tile distance;
//   * steps at distance >= kTile run in global memory, one launch each,
//     one thread per compare-exchange.
//
// Bound on the H100: memory at these sizes. The function reads 8n bytes
// and writes 8n; the network does n/2 * log2(m) * (log2(m)+1) / 2 compares
// (m = n rounded up to a power of two), and each global step moves the
// whole array through HBM once, so beyond one tile the kernel moves about
// 16n * (global steps + shared stages + 1) bytes.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 2048;            // elements per shared-memory tile
constexpr int kThreads = kTile / 2;    // one compare-exchange per thread
constexpr int kGlobalThreads = 256;

__device__ __forceinline__ void compare_exchange(int* keys, int* vals,
                                                 long long i, long long l) {
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

// The steps of one stage below the tile distance, in shared memory: the
// flip step first when `flip_k` > 0 (stages that fit in a tile), then the
// half-cleaners from `dist` down to 1. `valid` is how many of the tile's
// elements are real.
__device__ void tile_steps(int* sk, int* sv, int valid, int flip_k, int dist) {
  const int t = threadIdx.x;
  if (flip_k > 0) {
    const int h = flip_k >> 1;
    const int o = t & (h - 1);
    const int i = ((t - o) << 1) + o;
    const int l = ((t - o) << 1) + flip_k - 1 - o;
    if (l < valid) compare_exchange(sk, sv, i, l);
    __syncthreads();
  }
  for (int j = dist; j >= 1; j >>= 1) {
    const int o = t & (j - 1);
    const int i = ((t - o) << 1) + o;
    if (i + j < valid) compare_exchange(sk, sv, i, i + j);
    __syncthreads();
  }
}

// Sort every kTile-element tile ascending: stages 2 .. kTile. Reads the
// inputs, writes the outputs (the later passes work in place there).
__global__ void sort_tiles_kernel(const int* __restrict__ keys_in,
                                  const int* __restrict__ vals_in,
                                  int* __restrict__ keys_out,
                                  int* __restrict__ vals_out, long long n) {
  __shared__ int sk[kTile];
  __shared__ int sv[kTile];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int valid = static_cast<int>(n - base < kTile ? n - base : kTile);
  for (int e = threadIdx.x; e < valid; e += kThreads) {
    sk[e] = keys_in[base + e];
    sv[e] = vals_in[base + e];
  }
  __syncthreads();
  for (int k = 2; k <= kTile; k <<= 1) tile_steps(sk, sv, valid, k, k >> 2);
  for (int e = threadIdx.x; e < valid; e += kThreads) {
    keys_out[base + e] = sk[e];
    vals_out[base + e] = sv[e];
  }
}

// The half-cleaner steps at distances kTile/2 .. 1 of a stage above the
// tile size, in place.
__global__ void merge_tiles_kernel(int* __restrict__ keys,
                                   int* __restrict__ vals, long long n) {
  __shared__ int sk[kTile];
  __shared__ int sv[kTile];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int valid = static_cast<int>(n - base < kTile ? n - base : kTile);
  for (int e = threadIdx.x; e < valid; e += kThreads) {
    sk[e] = keys[base + e];
    sv[e] = vals[base + e];
  }
  __syncthreads();
  tile_steps(sk, sv, valid, 0, kTile >> 1);
  for (int e = threadIdx.x; e < valid; e += kThreads) {
    keys[base + e] = sk[e];
    vals[base + e] = sv[e];
  }
}

// One step at distance >= kTile in global memory: the flip step of stage
// `k` when `flip` is set, else the half-cleaner at distance `k`.
__global__ void global_step_kernel(int* __restrict__ keys,
                                   int* __restrict__ vals, long long n,
                                   long long pairs, long long k, bool flip) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kGlobalThreads + threadIdx.x;
  if (t >= pairs) return;
  if (flip) {
    const long long h = k >> 1;
    const long long o = t & (h - 1);
    const long long start = (t - o) << 1;
    const long long l = start + k - 1 - o;
    if (l < n) compare_exchange(keys, vals, start + o, l);
  } else {
    const long long o = t & (k - 1);
    const long long i = ((t - o) << 1) + o;
    if (i + k < n) compare_exchange(keys, vals, i, i + k);
  }
}

}  // namespace

// Sort (keys_in, vals_in) into (keys_out, vals_out) on `stream`, every
// step launched in order; returns the first cudaGetLastError() that is not
// cudaSuccess, else cudaSuccess. Requires 1 <= n <= 2^30 (the binding
// checks it).
extern "C" int bitonic_sort_launch(const int* keys_in, const int* vals_in,
                                   long long n, int* keys_out, int* vals_out,
                                   cudaStream_t stream) {
  long long m = 1;
  while (m < n) m <<= 1;
  const long long tiles = (n + kTile - 1) / kTile;
  sort_tiles_kernel<<<tiles, kThreads, 0, stream>>>(keys_in, vals_in,
                                                    keys_out, vals_out, n);
  cudaError_t err = cudaGetLastError();
  const long long pairs = m >> 1;
  const long long blocks = (pairs + kGlobalThreads - 1) / kGlobalThreads;
  for (long long k = 2LL * kTile; k <= m && err == cudaSuccess; k <<= 1) {
    global_step_kernel<<<blocks, kGlobalThreads, 0, stream>>>(
        keys_out, vals_out, n, pairs, k, true);
    err = cudaGetLastError();
    for (long long j = k >> 2; j >= kTile && err == cudaSuccess; j >>= 1) {
      global_step_kernel<<<blocks, kGlobalThreads, 0, stream>>>(
          keys_out, vals_out, n, pairs, j, false);
      err = cudaGetLastError();
    }
    if (err != cudaSuccess) break;
    merge_tiles_kernel<<<tiles, kThreads, 0, stream>>>(keys_out, vals_out, n);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
