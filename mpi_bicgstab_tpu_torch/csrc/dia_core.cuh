// DIA row core shared by the DIA SpMV (dia_spmv.cu) and the fused passes
// of classic (fused_classic.cu), CA (fused_ca.cu) and pipelined
// (fused_pipe.cu) BiCGStab: the counterpart of the Pallas `_dia_core`
// (mpi_bicgstab_tpu/ops/pallas_fused_pipe.py), plus the deterministic
// two-stage dot reduction every fused pass ends with.
//
// Layout: vals is [W, n] row-major, vals[w * n + i] = A[i, i + off[w]].
// One thread owns one row i. A diagonal offset is a plain element offset
// j = i + off[w]; neighbouring threads read neighbouring addresses, so
// every load of the band and of the source vector is coalesced. The
// Pallas kernels' (8,128) tiles, lane rolls and chunk-head DMAs exist for
// the TPU's VMEM and have no counterpart here.
//
// Columns outside [lo, hi) are skipped, never read: the band values there
// are 0, but 0 * garbage can be NaN (the JAX kernels need zero margins
// for the same reason, pallas_fused_classic.py:237-247). On one device
// [lo, hi) is [0, n). In the halo form of a row-partitioned solve
// (solvers/fused_dist.py) every source vector carries h entries of each
// neighbour's edge rows before and after the rank's n, so a column may lie
// in [-h, n + h): lo is -h where a previous rank exists, hi is n + h where
// a next one does, and the ends of the matrix keep 0 and n.
#pragma once

#include <cuda_runtime.h>

#define MBT_MAX_DIAGS 64
#define MBT_BLOCK 256      // threads (rows) per block of every row kernel
#define MBT_FIN_BLOCK 1024 // threads of the one-block partial-sum stage

// The offsets travel as a by-value kernel parameter (__grid_constant__):
// they sit in the constant bank, every thread of a warp reads the same
// one, and no device array or copy to a __constant__ symbol is needed.
struct DiaOffsets {
  int n_diags;
  int off[MBT_MAX_DIAGS];
};

// Fill `o` from a host array; false when there are too many diagonals.
static inline bool mbt_fill_offsets(DiaOffsets& o, const int* offsets,
                                    int n_diags) {
  if (n_diags < 0 || n_diags > MBT_MAX_DIAGS) return false;
  o.n_diags = n_diags;
  for (int w = 0; w < n_diags; ++w) o.off[w] = offsets[w];
  return true;
}

// sum_w vals[w, i] * src(i + off[w]) over the columns in [lo, hi).
// The band values are read once and never again: __ldcs marks them
// evict-first so that they do not push the source vectors (reread by
// the neighbouring rows' threads) out of L2.
template <typename T, typename Src>
__device__ __forceinline__ T dia_row(const DiaOffsets& offs,
                                     const T* __restrict__ vals,
                                     long long n, long long i, long long lo,
                                     long long hi, Src src) {
  T acc = T(0);
  for (int w = 0; w < offs.n_diags; ++w) {
    const long long j = i + offs.off[w];
    const T a = __ldcs(vals + (long long)w * n + i);
    if (j >= lo && j < hi) acc += a * src(j);
  }
  return acc;
}

// The column bounds a band launcher takes must hold the rank's own rows:
// lo <= 0 and hi >= n. That the source vectors hold [lo, hi) is the
// wrapper's check (ops/cuda_spmv.Halo).
static inline bool mbt_bounds_ok(long long n, long long lo, long long hi) {
  return lo <= 0 && hi >= n;
}

// Is [lo, hi) a halo form's? The band kernels take it as a template flag:
// their instance for [0, n) tests the constant bounds of the kernel before
// the halo form (its code, and its time, unchanged), the other [lo, hi).
static inline bool mbt_is_halo(long long n, long long lo, long long hi) {
  return lo != 0 || hi != n;
}

// A product and a sum each rounded on its own, never contracted into an
// FMA: the order of operations of a plain PyTorch twin, whose elementwise
// multiply and add round separately (the window and butterfly kernels).
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// Deterministic block sum of K per-thread values: warp shuffles, then
// one warp over the per-warp sums. The tree's shape depends only on
// blockDim, so the same inputs always give the same bits (no float
// atomics). Thread 0 writes out[k]. Every thread of the block must
// call it.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K],
                                          float* __restrict__ out) {
  __shared__ float warp_sums[K][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      v[k] += __shfl_down_sync(0xffffffffu, v[k], d);
    if (lane == 0) warp_sums[k][warp] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float t = lane < n_warps ? warp_sums[k][lane] : 0.0f;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        t += __shfl_down_sync(0xffffffffu, t, d);
      if (lane == 0) out[k] = t;
    }
  }
}

// Second stage of every dot: block k sums column k of the [G, K]
// per-block partials in a fixed order (thread t takes rows t,
// t + blockDim, ...), then block_sum. The K dots run side by side, one
// block each; a dot's order of additions depends only on G and the
// block size. Counterpart of the XLA sum of the Pallas partial rows
// (pallas_fused_classic.py:319).
template <int K>
__global__ void __launch_bounds__(MBT_FIN_BLOCK)
    sum_partials(const float* __restrict__ partials, long long G,
                 float* __restrict__ out) {
  const int k = blockIdx.x;
  float v[1] = {0.0f};
  for (long long g = threadIdx.x; g < G; g += blockDim.x)
    v[0] += partials[g * K + k];
  block_sum<1>(v, out + k);
}

static inline long long mbt_grid(long long n) {
  return (n + MBT_BLOCK - 1) / MBT_BLOCK;
}

// After a row pass's launch: report a refused launch, else launch the
// fixed-order sum of its G partial rows into dots[K] on the same stream.
template <int K>
static cudaError_t mbt_finish(const float* partials, long long G,
                              float* dots, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials<K><<<K, MBT_FIN_BLOCK, 0, stream>>>(partials, G, dots);
  return cudaGetLastError();
}

// Queries every kernel library exports. Each .cu file is built alone
// into its own shared library (ops/_build.py), so each definition below
// lands in exactly one translation unit per library.
extern "C" {

int mbt_block_rows(void) { return MBT_BLOCK; }

int mbt_max_diags(void) { return MBT_MAX_DIAGS; }

const char* mbt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
