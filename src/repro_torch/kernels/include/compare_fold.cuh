// The warp reduce-scatter of per-row counts, shared by the compare paths
// of csrc/sort_ranks.cu and csrc/match_layout.cu.
//
// A block of those paths owns kRows = 32 rows, one per lane, and each of
// its threads counts, in acc[r], what it saw for every row r. fold<16>
// meets a warp's 32 counts of each row in one lane: after the step of
// distance S, acc[k] (k < S) holds the partial count of row k + (the
// lane's bits from S up), summed over the lanes that differ from it below
// 2S; after S = 1, acc[0] of lane r is the warp's count of row r. 31
// shuffles, integer adds only: the result does not depend on any order.
#pragma once

#include <cuda_runtime.h>

namespace {
namespace compare {

constexpr int kRows = 32;  // rows a block owns: one per lane
constexpr unsigned kFull = 0xffffffffu;

template <int S>
__device__ __forceinline__ void fold(int (&acc)[kRows], int lane) {
  const bool upper = lane & S;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int send = upper ? acc[k] : acc[k + S];
    const int keep = upper ? acc[k + S] : acc[k];
    acc[k] = keep + __shfl_xor_sync(kFull, send, S);
  }
  if constexpr (S > 1) fold<S / 2>(acc, lane);
}

}  // namespace compare
}  // namespace
