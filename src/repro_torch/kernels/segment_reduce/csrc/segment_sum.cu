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
// holds here. Sorted ids make every segment a contiguous row range, so each
// block owns one (segment, 128-column tile): it finds the segment's rows
// [lower_bound(s), lower_bound(s + 1)) by binary search over `ids` and each
// thread sums its column over those rows in row order, in float32, then
// casts to the data's type. No atomics, deterministic, any S. Ids below 0
// or at least S fall in no segment's range and are dropped, as
// jax.ops.segment_sum drops them.
//
// Bound on the H100: memory. The function reads data (n * d elements) and
// ids (4n bytes) once and writes out (S * d elements) once; the adds are
// n * d. Neighbouring threads read neighbouring columns of one row, so the
// row reads coalesce. A segment's rows are summed by one block, so a few
// huge segments leave SMs idle; splitting long segments is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // columns per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// First index r in [0, n) with ids[r] >= v (n if none).
__device__ int lower_bound(const int* __restrict__ ids, int n, int v) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(ids + mid) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename T>
__global__ void segment_sum_kernel(const T* __restrict__ data,
                                   const int* __restrict__ ids, int n, int d,
                                   T* __restrict__ out) {
  __shared__ int range[2];
  const int s = blockIdx.x;
  if (threadIdx.x < 2) {
    range[threadIdx.x] = lower_bound(ids, n, s + static_cast<int>(threadIdx.x));
  }
  __syncthreads();
  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= d) return;
  float acc = 0.0f;
  const int end = range[1];
#pragma unroll 4
  for (int r = range[0]; r < end; ++r) {
    acc += to_f32(data[static_cast<size_t>(r) * d + c]);
  }
  out[static_cast<size_t>(s) * d + c] = from_f32<T>(acc);
}

template <typename T>
int launch(const T* data, const int* ids, int n, int d, int num_segments,
           T* out, cudaStream_t stream) {
  const dim3 grid(num_segments, (d + kThreads - 1) / kThreads);
  segment_sum_kernel<T><<<grid, kThreads, 0, stream>>>(data, ids, n, d, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; each returns cudaGetLastError() after the launch.
// Require n >= 0, 1 <= d <= 65535 * 128 and num_segments >= 1 (the binding
// checks them).
extern "C" int segment_sum_f32_launch(const float* data, const int* ids,
                                      int n, int d, int num_segments,
                                      float* out, cudaStream_t stream) {
  return launch(data, ids, n, d, num_segments, out, stream);
}

extern "C" int segment_sum_bf16_launch(const __nv_bfloat16* data,
                                       const int* ids, int n, int d,
                                       int num_segments, __nv_bfloat16* out,
                                       cudaStream_t stream) {
  return launch(data, ids, n, d, num_segments, out, stream);
}
