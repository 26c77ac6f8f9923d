// Sorted segment sum: out[s, :] = sum of data[r, :] over rows with ids[r] == s.
//
// Replaces the Pallas TPU kernel `_seg_sum_kernel` in
// src/repro/kernels/segment_reduce/kernel.py (launched by
// sorted_segment_sum_pallas).
//
// The TPU kernel turns the reduce into onehot(ids)^T @ data on the MXU, one
// 512-row tile per sequential grid step, accumulating the whole (S, d)
// output in a revisited VMEM block; that needs S small (its wrapper routes
// S > 4096 to the jnp reference) and grid steps that run in order. Neither
// holds here. Sorted ids make every segment a contiguous row range.
//
// Bound on the H100: memory. The function reads data (n * d elements) and
// ids (4n bytes) once and writes out (S * d elements) once; its n * d adds
// are far below the card's rate. So the design spreads the bytes evenly
// over the SMs whatever the segment sizes, and moves each once:
//
//   * the rows are cut into chunks of R rows (R a power of two from 8 to
//     512: the longest that still gives about two blocks per SM). A unit
//     of G threads (G = the row's 16-byte vectors, rounded up to a power
//     of two, at most 32) sums one chunk over G vectors of columns; a
//     block of 256 threads holds 256 / G units of consecutive chunks.
//     Each thread reads 16 bytes per row (4 float32 or 8 bfloat16) and
//     keeps 16 rows' loads in flight; where d is not a multiple of the
//     vector or a base is not 16-byte aligned, the same kernel loads and
//     stores element by element;
//   * a block stages its rows' ids (and one on each side) in shared memory
//     with one coalesced read and finds the segment ends there; no search
//     over global ids;
//   * a segment that starts and ends inside a chunk is summed in row order
//     in float32, compensated (Kahan: the rounding each add loses is kept
//     and taken back, so a sum over 2^19 rows stays within a few float32
//     roundings of the exact sum), and written once, in the data's type.
//     The compensation costs adds only, and this kernel is bound by its
//     bytes, not its adds. A segment that crosses a chunk edge leaves
//     float32 partials in a carry buffer (chunks, 2, d): slot 0 holds the
//     chunk's first segment when it comes from the chunk before, slot 1
//     its last segment when it goes on into the next. A second launch
//     finishes each crossing segment: the block of its first chunk adds
//     the segment's partials (compensated too), lane by lane in a fixed
//     interleaving and then the lanes in order. The order of every sum is
//     fixed by the shapes: no floating-point atomics, and two runs give
//     the same bits. A segment of half the rows is read by every SM, not
//     by one;
//   * empty segments are written as zeros by the unit that sees the gap in
//     the ids (the first chunk those below the first id, the last those
//     above the last id), so no separate zeroing pass runs. Ids below 0 or
//     at least S are summed into nothing and written nowhere, as
//     jax.ops.segment_sum drops them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlockRows = 8192;  // ids staged per block
constexpr int kUnroll = 16;          // rows loaded ahead by each thread
constexpr int kMinChunk = 8;
constexpr int kMaxChunk = 512;
constexpr int kMinBlocks = 256;  // about two blocks per SM, where n allows

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kWidth = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static float to_f32(float x) { return x; }
  __device__ static float from_f32(float x) { return x; }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kWidth = 8;
  __device__ static float2 half_pair(unsigned w) {
    __nv_bfloat162 h;
    memcpy(&h, &w, sizeof(w));
    return __bfloat1622float2(h);
  }
  __device__ static unsigned pair_bits(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    unsigned w;
    memcpy(&w, &h, sizeof(w));
    return w;
  }
  __device__ static void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = half_pair(w[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(pair_bits(f[0], f[1]), pair_bits(f[2], f[3]),
                      pair_bits(f[4], f[5]), pair_bits(f[6], f[7]));
  }
  __device__ static float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ static __nv_bfloat16 from_f32(float x) {
    return __float2bfloat16(x);
  }
};

// The launch's shape, the same for both kernels.
struct Plan {
  int vec_cols;    // 16-byte vectors per row (the last may be partial)
  int group;       // G: threads per unit, one column vector each
  int units;       // units (chunks) per block
  int chunk;       // R: rows per chunk
  int chunks;      // at least 1, so n == 0 still zero-fills
  int col_tiles;   // grid y
};

Plan make_plan(int n, int d, int width) {
  Plan p;
  p.vec_cols = (d + width - 1) / width;
  p.group = 1;
  while (p.group < p.vec_cols && p.group < 32) p.group <<= 1;
  p.units = kThreads / p.group;
  // the longest chunk (fewest carries) that still gives kMinBlocks blocks
  p.chunk = kMaxChunk;
  auto blocks = [&](long long chunk) {
    return ((n + chunk - 1) / chunk + p.units - 1) / p.units;
  };
  while (p.chunk > kMinChunk && blocks(p.chunk) < kMinBlocks) p.chunk >>= 1;
  while (p.chunk * p.units > kMaxBlockRows) p.chunk >>= 1;
  p.chunks = n > 0 ? (n + p.chunk - 1) / p.chunk : 1;
  p.col_tiles = (p.vec_cols + p.group - 1) / p.group;
  return p;
}

// Compensated (Kahan) float32 sums: `acc` the running sum, `err` the
// rounding it has lost; acc - err is the sum. The order of the adds is
// the caller's, and the intrinsics are never contracted or reordered.
template <int W>
__device__ __forceinline__ void kahan_add(float* acc, float* err,
                                          const float* x) {
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float y = __fsub_rn(x[j], err[j]);
    const float t = __fadd_rn(acc[j], y);
    err[j] = __fsub_rn(__fsub_rn(t, acc[j]), y);
    acc[j] = t;
  }
}

template <int W>
__device__ __forceinline__ void kahan_total(float* acc, float* err) {
#pragma unroll
  for (int j = 0; j < W; ++j) {
    acc[j] = __fsub_rn(acc[j], err[j]);
    err[j] = 0.f;
  }
}

// One thread's VEC columns [c0, c0 + VEC) of row `row` of a (rows, d)
// matrix, element by element inside d (the path when d is not a multiple
// of VEC or a base is not 16-byte aligned).
template <typename T>
__device__ __forceinline__ void load_cols_scalar(const T* __restrict__ m,
                                                 size_t row, int d, int c0,
                                                 float* f) {
  constexpr int W = Vec<T>::kWidth;
  const T* p = m + row * d + c0;
#pragma unroll
  for (int j = 0; j < W; ++j) f[j] = c0 + j < d ? Vec<T>::to_f32(p[j]) : 0.f;
}

template <typename T>
__device__ __forceinline__ void store_cols(T* __restrict__ m, size_t row,
                                           int d, int c0, bool vec,
                                           const float* f) {
  constexpr int W = Vec<T>::kWidth;
  T* p = m + row * d + c0;
  if (vec) {
    *reinterpret_cast<uint4*>(p) = Vec<T>::pack(f);
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (c0 + j < d) p[j] = Vec<T>::from_f32(f[j]);
    }
  }
}

template <int W>
__device__ __forceinline__ void store_carry(float* __restrict__ carry,
                                            size_t row, int d, int c0,
                                            const float* f) {
  float* p = carry + row * d + c0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if (c0 + j < d) p[j] = f[j];
  }
}

// Zeros for segments [lo, hi) clipped to [0, S).
template <typename T>
__device__ void zero_fill(T* __restrict__ out, long long lo, long long hi,
                          int S, int d, int c0, bool vec) {
  float z[Vec<T>::kWidth] = {};
  if (lo < 0) lo = 0;
  if (hi > S) hi = S;
  for (long long s = lo; s < hi; ++s) store_cols(out, s, d, c0, vec, z);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    chunk_sum_kernel(const T* __restrict__ data, const int* __restrict__ ids,
                     int n, int d, int S, Plan plan, bool vec,
                     T* __restrict__ out, float* __restrict__ carry) {
  constexpr int W = Vec<T>::kWidth;
  __shared__ int s_ids[kMaxBlockRows + 2];
  const long long rb0 =
      static_cast<long long>(blockIdx.x) * plan.units * plan.chunk;
  const long long rb1 =
      min(static_cast<long long>(n), rb0 + plan.units * plan.chunk);
  // s_ids[i] = ids[rb0 - 1 + i], for the rows that exist
  for (long long i = threadIdx.x; i < rb1 - rb0 + 2; i += kThreads) {
    const long long r = rb0 - 1 + i;
    if (r >= 0 && r < n) s_ids[i] = ids[r];
  }
  __syncthreads();
  const int unit = threadIdx.x / plan.group;
  const int chunk = blockIdx.x * plan.units + unit;
  const int cv = blockIdx.y * plan.group + threadIdx.x % plan.group;
  if (chunk >= plan.chunks || cv >= plan.vec_cols) return;
  const int c0 = cv * W;
  const long long r0 = static_cast<long long>(chunk) * plan.chunk;
  const long long r1 = min(static_cast<long long>(n), r0 + plan.chunk);
  auto id_at = [&](long long r) { return s_ids[r - rb0 + 1]; };
  if (r0 == 0) zero_fill(out, 0, n > 0 ? id_at(0) : S, S, d, c0, vec);
  float acc[W] = {};
  float err[W] = {};
  long long seg_start = r0;
  for (long long rb = r0; rb < r1; rb += kUnroll) {
    uint4 raw[kUnroll];  // 16 bytes of each row, all loads in flight
    if (vec) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (rb + u < r1) {
          raw[u] = __ldg(reinterpret_cast<const uint4*>(
              data + static_cast<size_t>(rb + u) * d + c0));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = rb + u;
      if (r >= r1) break;
      float x[W];
      if (vec) {
        Vec<T>::unpack(raw[u], x);
      } else {
        load_cols_scalar(data, r, d, c0, x);
      }
      kahan_add<W>(acc, err, x);
      const int id = id_at(r);
      const bool ends = r + 1 == n || id_at(r + 1) != id;
      if (!ends && r + 1 < r1) continue;
      kahan_total<W>(acc, err);
      if (id >= 0 && id < S) {
        const bool from_left = seg_start == r0 && r0 > 0 && id_at(r0 - 1) == id;
        if (from_left) {
          store_carry<W>(carry, 2LL * chunk, d, c0, acc);
        } else if (!ends) {  // goes on into the next chunk
          store_carry<W>(carry, 2LL * chunk + 1, d, c0, acc);
        } else {
          store_cols(out, id, d, c0, vec, acc);
        }
      }
      if (ends) {
        zero_fill(out, static_cast<long long>(id) + 1,
                  r + 1 == n ? S : id_at(r + 1), S, d, c0, vec);
      }
#pragma unroll
      for (int j = 0; j < W; ++j) acc[j] = 0.f;
      seg_start = r + 1;
    }
  }
}

// A thread's W columns of one carry row, as float4s when d % 4 == 0.
template <int W>
__device__ __forceinline__ void load_partial(const float* __restrict__ row,
                                             int d, int c0, bool vec4,
                                             float* x) {
  const float* p = row + c0;
  if (vec4) {
#pragma unroll
    for (int j = 0; j < W; j += 4) {
      const float4 q = c0 + j < d
          ? __ldg(reinterpret_cast<const float4*>(p + j))
          : make_float4(0.f, 0.f, 0.f, 0.f);
      x[j] = q.x;
      x[j + 1] = q.y;
      x[j + 2] = q.z;
      x[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) x[j] = c0 + j < d ? p[j] : 0.f;
  }
}

// Finish each segment that crosses a chunk edge. Block c acts when its
// last segment goes on into chunk c + 1 and starts in c: it adds carry
// slot 1 of chunk c and slot 0 of chunks c + 1 .. e (e the segment's last
// chunk). Lane l of the block's 256 / G lanes adds partials l, l + L, ...
// in order; then the lanes are added in order. Most crossing segments end
// in chunk c + 1: that case costs one round of loads, and most blocks
// finish nothing or two partials, so the launch is a matter of how many
// blocks are resident at once (hence the register cap).
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)  // 4 blocks per SM: most
    finish_kernel(const int* __restrict__ ids, int n, int d, int S, Plan plan,
                  bool vec, const float* __restrict__ carry,
                  T* __restrict__ out) {
  constexpr int W = Vec<T>::kWidth;
  constexpr int kBatch = 32 / W;  // partials in flight per lane
  __shared__ float lanes[kThreads * W];
  __shared__ int last_chunk;
  const int c = blockIdx.x;
  const long long r1 = static_cast<long long>(c + 1) * plan.chunk;
  if (r1 >= n) return;
  const int lane = threadIdx.x / plan.group;
  const int tx = threadIdx.x % plan.group;
  const int c0 = (blockIdx.y * plan.group + tx) * W;
  const bool vec4 = d % 4 == 0;  // carry rows then hold float4s
  auto holds = [&](int k, int s) {  // chunk k starts inside segment s
    return ids[static_cast<long long>(k) * plan.chunk] == s;
  };
  auto partial = [&](int k) {  // the k-th partial of the segment
    return carry + (k == 0 ? 2LL * c + 1 : 2LL * (c + k)) * d;
  };
  // every load of the usual case at once: the ids that decide whether
  // this block finishes a segment and whether it ends in chunk c + 1,
  // and the first two partials (read before they are known to be needed)
  const int s = ids[r1 - 1];
  const bool goes_on = ids[r1] == s;
  const bool from_before =
      c > 0 && ids[static_cast<long long>(c) * plan.chunk - 1] == s;
  const bool beyond = c + 2 < plan.chunks && holds(c + 2, s);
  float first[W] = {};
  if (lane < 2 && c0 < d) load_partial<W>(partial(lane), d, c0, vec4, first);
  if (!goes_on || s < 0 || s >= S || from_before) return;
  int count = 2;  // partials: slot 1 of chunk c, slot 0 of chunks c + 1 ..
  if (beyond) {
    if (threadIdx.x == 0) {
      // the largest k with chunk k starting inside s (chunk starts are
      // sorted, and k = c + 2 holds): gallop forward, then halve the
      // last step
      int lo = c + 2;
      int step = 1;
      while (lo + step < plan.chunks && holds(lo + step, s)) {
        lo += step;
        step <<= 1;
      }
      int hi = min(lo + step, plan.chunks) - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (holds(mid, s)) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      last_chunk = lo;
    }
    __syncthreads();
    count = last_chunk - c + 1;
  }
  float acc[W] = {};
  float err[W] = {};
  if (c0 < d) {
    if (lane < 2) kahan_add<W>(acc, err, first);
    // the lane's later partials, k0, k0 + L, ... k0 + (kBatch - 1) L
    // loaded together, then added in that order
    for (int k0 = lane < 2 ? lane + plan.units : lane; k0 < count;
         k0 += plan.units * kBatch) {
      float x[kBatch][W];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int k = k0 + b * plan.units;
        if (k < count) load_partial<W>(partial(k), d, c0, vec4, x[b]);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (k0 + b * plan.units < count) kahan_add<W>(acc, err, x[b]);
      }
    }
  }
  kahan_total<W>(acc, err);
#pragma unroll
  for (int j = 0; j < W; ++j) lanes[threadIdx.x * W + j] = acc[j];
  __syncthreads();
  if (lane != 0 || c0 >= d) return;
  for (int l = 1; l < plan.units; ++l) {
    kahan_add<W>(acc, err, lanes + (l * plan.group + tx) * W);
  }
  kahan_total<W>(acc, err);
  store_cols(out, s, d, c0, vec, acc);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch(const T* data, const int* ids, int n, int d, int num_segments,
           T* out, float* carry, int* device_launches, cudaStream_t stream) {
  const Plan plan = make_plan(n, d, Vec<T>::kWidth);
  const bool vec = d % Vec<T>::kWidth == 0 && aligned16(data) && aligned16(out);
  const dim3 grid((plan.chunks + plan.units - 1) / plan.units, plan.col_tiles);
  chunk_sum_kernel<T><<<grid, kThreads, 0, stream>>>(
      data, ids, n, d, num_segments, plan, vec, out, carry);
  *device_launches = 1;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || plan.chunks < 2) return static_cast<int>(err);
  finish_kernel<T><<<dim3(plan.chunks, plan.col_tiles), kThreads, 0, stream>>>(
      ids, n, d, num_segments, plan, vec, carry, out);
  *device_launches = 2;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows of the float32 carry buffer a call needs, over 2 * d columns: the
// number of chunks.
extern "C" int segment_sum_chunks(int n, int d, int elem_bytes) {
  return make_plan(n, d, 16 / elem_bytes).chunks;
}

// Launch on `stream`; each returns cudaGetLastError() after the last
// launch and writes how many device launches it made. `carry` holds
// segment_sum_chunks(n, d, elem) * 2 * d floats. Require n >= 0,
// 1 <= d <= 65535 * 128 and num_segments >= 1 (the binding checks them).
extern "C" int segment_sum_f32_launch(const float* data, const int* ids,
                                      int n, int d, int num_segments,
                                      float* out, float* carry,
                                      int* device_launches,
                                      cudaStream_t stream) {
  return launch(data, ids, n, d, num_segments, out, carry, device_launches,
                stream);
}

extern "C" int segment_sum_bf16_launch(const __nv_bfloat16* data,
                                       const int* ids, int n, int d,
                                       int num_segments, __nv_bfloat16* out,
                                       float* carry, int* device_launches,
                                       cudaStream_t stream) {
  return launch(data, ids, n, d, num_segments, out, carry, device_launches,
                stream);
}
