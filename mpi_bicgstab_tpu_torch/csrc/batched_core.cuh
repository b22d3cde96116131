// Row core of the batched DIA kernels (batched_spmv.cu, fused_batched.cu):
// the DIA row of dia_core.cuh applied to K right-hand-side lanes at once.
//
// Layout: the lanes are [K, n] row-major, lane l's row j at l * n + j.
// One thread owns one row i of every lane. It loads each band value
// vals[w, i] ONCE and multiplies it into the K lanes' accumulators, which
// live in registers (K is a template parameter, so the lane loops unroll).
// Reading the band once for the whole batch is the point of the batched
// kernels: the band (96 MB at n = 1,602,112, W = 15) is most of an
// SpMV's traffic, and K single-lane SpMVs would read it K times.
#pragma once

#include "dia_core.cuh"

#define MBT_MAX_LANES 8

// acc[l] = sum_w vals[w, i] * src(l, i + off[w]) for every lane l < K,
// over the in-range columns (out-of-range ones are skipped, never read),
// diagonal by diagonal in offset order as dia_row does.
template <int K, typename Src>
__device__ __forceinline__ void dia_row_lanes(const DiaOffsets& offs,
                                              const float* __restrict__ vals,
                                              long long n, long long i,
                                              const Src& src, float (&acc)[K]) {
#pragma unroll
  for (int l = 0; l < K; ++l) acc[l] = 0.0f;
  for (int w = 0; w < offs.n_diags; ++w) {
    const long long j = i + offs.off[w];
    const float a = __ldcs(vals + (long long)w * n + i);
    if (j >= 0 && j < n) {
#pragma unroll
      for (int l = 0; l < K; ++l) acc[l] += a * src(l, j);
    }
  }
}

// In a launcher returning cudaError_t: `call` with the compile-time lane
// count K equal to the runtime k (1 .. MBT_MAX_LANES); any other k is
// refused with cudaErrorInvalidValue.
#define MBT_BY_LANES(k, call)                \
  switch (k) {                               \
    case 1: { constexpr int K = 1; return call; } \
    case 2: { constexpr int K = 2; return call; } \
    case 3: { constexpr int K = 3; return call; } \
    case 4: { constexpr int K = 4; return call; } \
    case 5: { constexpr int K = 5; return call; } \
    case 6: { constexpr int K = 6; return call; } \
    case 7: { constexpr int K = 7; return call; } \
    case 8: { constexpr int K = 8; return call; } \
  }                                          \
  return cudaErrorInvalidValue

extern "C" int mbt_max_lanes(void) { return MBT_MAX_LANES; }
