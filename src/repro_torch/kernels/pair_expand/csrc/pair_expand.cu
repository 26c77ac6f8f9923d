// ReduceDuplicate pair expansion (the expand half of MapSQ's Algorithm 1).
//
// Replaces the Pallas TPU kernel `_pair_expand_kernel` in
// src/repro/kernels/pair_expand/kernel.py (launched by pair_expand_pallas).
//
// For every output slot t < capacity: i = the first index with inclusive
// prefix[i] > t (clamped to n_left - 1), off = t - (prefix[i] - counts[i]),
// valid = t < prefix[n_left - 1]. Slots past the total keep the clamped
// row and its offset, exactly as the TPU kernel and the jnp reference
// compute them. `prefix` is non-decreasing (the inclusive sum of counts).
//
// Stacked form: `lanes` independent rows of (n_left,) inputs and
// (capacity,) outputs, the lane in the grid's y dimension, so a stacked
// same-shape batch is one launch (the reference vmaps the Pallas call).
// A single call is the one-lane case.
//
// Bound on the H100: memory. The function reads 8 bytes a row and writes
// 9 a slot (two int32 and a bool). The TPU kernel held prefix whole in
// VMEM and stepped every slot through the same log2(n_left) binary search;
// a port of that (a thread per slot, its own search through L2) made a
// chain of 21 dependent loads a slot at n_left = 2^20, the 256 slots of a
// block walking almost the same path, and reached a sixth of the bound.
// Design, above kSearchSlots slots a launch: a merge path. Expanding is
// merging prefix with the slots 0 .. capacity-1, where row a goes before
// slot t iff prefix[a] <= t; a slot's row is the number of rows merged
// before it. Row a sits at merge position a + clamp(prefix[a], 0,
// capacity), which grows strictly with a.
//
//   * Partition: block b owns merge positions [b * kTile, (b+1) * kTile),
//     rows and slots together, so a run of zero-count rows costs what any
//     rows cost (kTile = 2048: 128 threads of 16 steps, the fastest of the
//     block shapes timed on the H100). It finds its two split points
//     itself, one warp each: 32 lanes probe 32 evenly spaced rows a round,
//     ~4 rounds at 2^20 rows. One launch, no partition pass.
//   * Stage: the block's rows (at most kTile + 1) go to shared memory with
//     coalesced loads, as each row's merge bound and group start.
//   * Emit: each thread searches its own sub-diagonal in shared memory,
//     then walks kItems merge steps, recording each slot's row.
//   * Store: 16-byte stores of i and off and one 4-byte store of the valid
//     flags for 4 consecutive slots, streaming (evict-first, so the
//     outputs do not push prefix out of L2); scalar stores at an edge that
//     is not 16-byte aligned (a lane's row of slots starts anywhere).
//   * Tail: a block wholly past the total (up to half the slots at the
//     engine's power-of-two capacities) writes the clamped last row with
//     no search and no staging; a block of rows and no slots stops after
//     its split search (most blocks where the capacity is far below
//     n_left).
//
// Small launches (lanes * capacity <= kSearchSlots) keep a thread per slot
// and its own binary search through L2 instead: the engine's joins of up
// to millions of left rows with a few dozen matches, and Q9's joins of
// 2^18 slots, are such launches. There the work is too small to fill the
// card and a launch is as long as its chain of dependent steps, which is
// shorter for one search (log2 n_left loads that the slots of a warp
// share) than for the merge path's split search, staging and walk.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kItems = 16;  // merge steps a thread walks
constexpr int kTile = kThreads * kItems;  // merge positions of a block
static_assert(kTile < 65536, "a slot's row within a block fits 16 bits");
constexpr unsigned kFull = 0xffffffffu;
// Most slots a launch (all lanes) takes on the search path. chip_smoke.py
// times both designs at the engine's own shapes on the H100: up to 2^18
// slots the search took at most 4% longer than the merge path and up to
// 37% less; above, the merge path was the faster at all but one (PERF.md).
constexpr long long kSearchSlots = 1 << 18;
constexpr int kSearchThreads = 256;

__device__ __forceinline__ int clamp_slot(int p, int capacity) {
  return min(max(p, 0), capacity);
}

// Rows merged before position d, #{a : a + clamp(prefix[a]) < d}, by a
// 32-way search of one warp; every lane calls and gets the answer.
__device__ long long rows_before(const int* __restrict__ prefix, int n_left,
                                 int capacity, long long d) {
  const int lane = threadIdx.x & 31;
  long long lo = min(max(0LL, d - capacity), static_cast<long long>(n_left));
  long long hi = min(d, static_cast<long long>(n_left));
  while (lo < hi) {
    const long long span = hi - lo;
    const long long p = lo + span * lane / 32;
    const bool before = p + clamp_slot(__ldg(prefix + p), capacity) < d;
    const int m = __popc(__ballot_sync(kFull, before));  // lanes 0..m-1
    const long long next_lo = m > 0 ? lo + span * (m - 1) / 32 + 1 : lo;
    hi = m < 32 ? lo + span * m / 32 : hi;
    lo = next_lo;
  }
  return lo;
}

// Write slots t0 .. t0+count-1 of one lane (flat output index g0 + u for
// slot t0 + u); row_of(u) gives (i, off). Every thread of the block calls.
template <class RowOf>
__device__ __forceinline__ void store_slots(int* __restrict__ out_i,
                                            int* __restrict__ out_off,
                                            bool* __restrict__ out_valid,
                                            long long g0, int t0, int count,
                                            int total, bool vec,
                                            RowOf row_of) {
  const int head = vec ? min(count, static_cast<int>((4 - (g0 & 3)) & 3))
                       : count;
  for (int u = threadIdx.x; u < head; u += kThreads) {
    const int2 r = row_of(u);
    out_i[g0 + u] = r.x;
    out_off[g0 + u] = r.y;
    out_valid[g0 + u] = t0 + u < total;
  }
  const int groups = (count - head) >> 2;
  for (int q = threadIdx.x; q < groups; q += kThreads) {
    const int u = head + 4 * q;
    const int2 r0 = row_of(u);
    const int2 r1 = row_of(u + 1);
    const int2 r2 = row_of(u + 2);
    const int2 r3 = row_of(u + 3);
    const int t = t0 + u;
    const unsigned valid = static_cast<unsigned>(t < total) |
                           static_cast<unsigned>(t + 1 < total) << 8 |
                           static_cast<unsigned>(t + 2 < total) << 16 |
                           static_cast<unsigned>(t + 3 < total) << 24;
    __stcs(reinterpret_cast<int4*>(out_i + g0 + u),
           make_int4(r0.x, r1.x, r2.x, r3.x));
    __stcs(reinterpret_cast<int4*>(out_off + g0 + u),
           make_int4(r0.y, r1.y, r2.y, r3.y));
    __stcs(reinterpret_cast<unsigned*>(out_valid + g0 + u), valid);
  }
  for (int u = head + 4 * groups + threadIdx.x; u < count; u += kThreads) {
    const int2 r = row_of(u);
    out_i[g0 + u] = r.x;
    out_off[g0 + u] = r.y;
    out_valid[g0 + u] = t0 + u < total;
  }
}

__global__ void __launch_bounds__(kThreads)
    pair_expand_kernel(const int* __restrict__ prefix,
                       const int* __restrict__ counts, int n_left,
                       int capacity, int* __restrict__ out_i,
                       int* __restrict__ out_off,
                       bool* __restrict__ out_valid, bool vec) {
  __shared__ int s_bound[kTile + 1];  // row k's merge bound, less t0
  __shared__ int s_start[kTile + 1];  // row k's first slot (prefix - counts)
  __shared__ unsigned short s_row[kTile];  // each slot's row, less a0
  __shared__ long long s_split[2];
  prefix += static_cast<long long>(blockIdx.y) * n_left;
  counts += static_cast<long long>(blockIdx.y) * n_left;
  const long long g_base = static_cast<long long>(blockIdx.y) * capacity;
  const int total = __ldg(prefix + n_left - 1);
  const int last_start = total - __ldg(counts + n_left - 1);
  const long long d0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long d1 =
      min(d0 + kTile, static_cast<long long>(n_left) + capacity);

  // every row merges before n_left + clamp(total): past it, only slots
  if (d0 >= n_left + static_cast<long long>(clamp_slot(total, capacity))) {
    const int t0 = static_cast<int>(d0 - n_left);
    store_slots(out_i, out_off, out_valid, g_base + t0, t0,
                static_cast<int>(d1 - d0), total, vec, [&](int u) {
                  return make_int2(n_left - 1, t0 + u - last_start);
                });
    return;
  }

  if (threadIdx.x < 64) {  // warp 0 the block's first split, warp 1 its end
    const long long a = rows_before(prefix, n_left, capacity,
                                    threadIdx.x < 32 ? d0 : d1);
    if ((threadIdx.x & 31) == 0) s_split[threadIdx.x >> 5] = a;
  }
  __syncthreads();
  const int a0 = static_cast<int>(s_split[0]);
  const int a1 = static_cast<int>(s_split[1]);
  const int t0 = static_cast<int>(d0 - a0);
  const int na = a1 - a0;
  const int nt = static_cast<int>(d1 - a1) - t0;
  if (nt == 0) return;  // rows only: this block writes no slot

  // rows a0 .. a1 (a1 too: the slots after the block's last row are its)
  for (int k = threadIdx.x; k <= na; k += kThreads) {
    const int a = a0 + k;
    if (a < n_left) {
      const int p = __ldg(prefix + a);
      s_bound[k] = clamp_slot(p, capacity) - t0;
      s_start[k] = p - __ldg(counts + a);
    } else {  // past the last row: slots keep the clamped last row
      s_bound[k] = INT_MAX;
      s_start[k] = last_start;
    }
  }
  __syncthreads();

  // row k precedes the block's relative slot u iff s_bound[k] <= u, so it
  // sits at relative merge position k + s_bound[k]
  const int r = threadIdx.x * kItems;
  const int items = static_cast<int>(d1 - d0);
  if (r < items) {
    int lo = max(0, r - nt);
    int hi = min(r, na);
    while (lo < hi) {  // rows among the block's first r merge positions
      const int mid = (lo + hi) >> 1;
      if (s_bound[mid] < r - mid) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int k = lo;
    int u = r - lo;
    const int end = min(r + kItems, items);
    for (int step = r; step < end; ++step) {
      if (k < na && s_bound[k] <= u) {
        ++k;
      } else {
        s_row[u++] = k;
      }
    }
  }
  __syncthreads();

  store_slots(out_i, out_off, out_valid, g_base + t0, t0, nt, total, vec,
              [&](int u) {
                const int k = s_row[u];
                return make_int2(min(a0 + k, n_left - 1), t0 + u - s_start[k]);
              });
}

// The search path: slot t of lane blockIdx.y finds its row by a binary
// search of prefix (the first row whose inclusive prefix exceeds t).
__global__ void __launch_bounds__(kSearchThreads)
    slot_search_kernel(const int* __restrict__ prefix,
                       const int* __restrict__ counts, int n_left,
                       int capacity, int* __restrict__ out_i,
                       int* __restrict__ out_off,
                       bool* __restrict__ out_valid) {
  const int t = blockIdx.x * kSearchThreads + threadIdx.x;
  if (t >= capacity) return;
  prefix += static_cast<long long>(blockIdx.y) * n_left;
  counts += static_cast<long long>(blockIdx.y) * n_left;
  const long long out = static_cast<long long>(blockIdx.y) * capacity + t;
  int lo = 0;
  int hi = n_left;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(prefix + mid) <= t) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int i = min(lo, n_left - 1);
  out_i[out] = i;
  out_off[out] = t - (__ldg(prefix + i) - __ldg(counts + i));
  out_valid[out] = t < __ldg(prefix + n_left - 1);
}

bool search_path(int lanes, int capacity) {
  return static_cast<long long>(lanes) * capacity <= kSearchSlots;
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

// 1 if a launch of `lanes` rows of `capacity` slots takes the search path,
// 0 if the merge path.
extern "C" int pair_expand_search_path(int lanes, int capacity) {
  return search_path(lanes, capacity) ? 1 : 0;
}

// Launch on `stream`; returns cudaGetLastError() after the launch.
// Requires 1 <= lanes <= 65535, n_left >= 1 and capacity >= 1 (the binding
// checks all three).
extern "C" int pair_expand_launch(const int* prefix, const int* counts,
                                  int lanes, int n_left, int capacity,
                                  int* out_i, int* out_off, bool* out_valid,
                                  cudaStream_t stream) {
  if (search_path(lanes, capacity)) {
    const dim3 grid((capacity + kSearchThreads - 1) / kSearchThreads, lanes);
    slot_search_kernel<<<grid, kSearchThreads, 0, stream>>>(
        prefix, counts, n_left, capacity, out_i, out_off, out_valid);
    return static_cast<int>(cudaGetLastError());
  }
  const long long items = static_cast<long long>(n_left) + capacity;
  const dim3 grid(static_cast<unsigned>((items + kTile - 1) / kTile), lanes);
  const bool vec = aligned(out_i, 16) && aligned(out_off, 16) &&
                   aligned(out_valid, 4);
  pair_expand_kernel<<<grid, kThreads, 0, stream>>>(
      prefix, counts, n_left, capacity, out_i, out_off, out_valid, vec);
  return static_cast<int>(cudaGetLastError());
}
