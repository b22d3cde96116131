// Double-float (DF) arithmetic shared by the DF kernels: the DF DIA SpMV
// (dia_spmv.cu), the fused DF classic passes (fused_classic_df.cu), the
// fused DF CA passes (fused_ca_df.cu) and the fused DF pipelined phases
// (fused_pipe_df.cu).
// Counterpart of mpi_bicgstab_tpu/ops/precision.py (two_sum,
// quick_two_sum, two_prod, df_add, df_mul, df_div, df_fma), of the DF DIA
// core `_dia_core_df` (pallas_fused_pipe_df2.py:125-148) and of the
// compensated dot partials `_tile_df_dot` / `_sum_dot_rows`
// (pallas_fused_pipe_df.py:93-121,201-215).
//
// A DF value is an unevaluated pair hi + lo of floats. DF vectors travel
// as two float arrays (hi, lo); a DF band as two [W, n] arrays.
//
// Exactness: nvcc contracts a*b+c into an FMA by default, and a
// contracted EFT silently loses its error term. Every operation here is
// written with __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn, which are
// never contracted or reassociated, so each one rounds exactly as the
// plain PyTorch twin's (ops/precision.py) separate elementwise ops do.
// two_prod takes its error from one fused multiply-add,
// e = fma(a, b, -p): the exact error of a product is unique, so this is
// the same pair as the twin's Dekker product with the bitmask split.
#pragma once

#include "dia_core.cuh"

struct df_t {
  float hi, lo;
};

__device__ __forceinline__ df_t two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  return {s, __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb))};
}

// two_sum for |a| >= |b| (or a == 0)
__device__ __forceinline__ df_t quick_two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  return {s, __fsub_rn(b, __fsub_rn(s, a))};
}

__device__ __forceinline__ df_t two_prod(float a, float b) {
  const float p = __fmul_rn(a, b);
  return {p, __fmaf_rn(a, b, -p)};
}

__device__ __forceinline__ df_t df_neg(df_t a) { return {-a.hi, -a.lo}; }

// a.hi b.lo + a.lo b.hi, the cross terms of a DF product
__device__ __forceinline__ float df_cross(df_t a, df_t b) {
  return __fadd_rn(__fmul_rn(a.hi, b.lo), __fmul_rn(a.lo, b.hi));
}

__device__ __forceinline__ df_t df_add(df_t a, df_t b) {
  df_t s = two_sum(a.hi, b.hi);
  const df_t t = two_sum(a.lo, b.lo);
  s = quick_two_sum(s.hi, __fadd_rn(s.lo, t.hi));
  return quick_two_sum(s.hi, __fadd_rn(s.lo, t.lo));
}

__device__ __forceinline__ df_t df_mul(df_t a, df_t b) {
  const df_t p = two_prod(a.hi, b.hi);
  return quick_two_sum(p.hi, __fadd_rn(p.lo, df_cross(a, b)));
}

// long division, three quotient terms
__device__ __forceinline__ df_t df_div(df_t a, df_t b) {
  const float q1 = __fdiv_rn(a.hi, b.hi);
  df_t r = df_add(a, df_neg(df_mul(b, {q1, 0.0f})));
  const float q2 = __fdiv_rn(r.hi, b.hi);
  r = df_add(r, df_neg(df_mul(b, {q2, 0.0f})));
  const float q3 = __fdiv_rn(r.hi, b.hi);
  const df_t s = quick_two_sum(q1, q2);
  return quick_two_sum(s.hi, __fadd_rn(s.lo, q3));
}

// y + a b with one compensation step (ops/precision.df_fma)
__device__ __forceinline__ df_t df_fma(df_t y, df_t a, df_t b) {
  const df_t p = two_prod(a.hi, b.hi);
  const float e = __fadd_rn(p.lo, df_cross(a, b));
  const df_t s = two_sum(y.hi, p.hi);
  return quick_two_sum(s.hi, __fadd_rn(y.lo, __fadd_rn(e, s.lo)));
}

__device__ __forceinline__ df_t ld_df(const float* __restrict__ h,
                                      const float* __restrict__ l,
                                      long long j) {
  return {__ldg(h + j), __ldg(l + j)};
}

__device__ __forceinline__ void st_df(float* __restrict__ h,
                                      float* __restrict__ l, long long j,
                                      df_t v) {
  h[j] = v.hi;
  l[j] = v.lo;
}

// A stored DF vector, read as it is (the SpMV input of a pass that
// recomputes nothing at the neighbours).
struct WholeSrcDF {
  const float* __restrict__ h;
  const float* __restrict__ l;
  __device__ __forceinline__ df_t operator()(long long j) const {
    return ld_df(h, l, j);
  }
};

// sum_w vals[w, i] * src(i + off[w]), accumulated with df_fma from
// acc = 0, diagonal by diagonal in offset order (the plain twin's
// pad-plus-slice order). A column outside [lo, hi) (dia_row's bounds,
// dia_core.cuh) is never read: its source value is the pair (0, 0),
// exactly what the twin's zero padding gives, so every row takes the
// twin's operation sequence bit for bit. The band streams evict-first, as
// in dia_row.
template <typename Src>
__device__ __forceinline__ df_t dia_row_df(const DiaOffsets& offs,
                                           const float* __restrict__ vh,
                                           const float* __restrict__ vl,
                                           long long n, long long i,
                                           long long lo, long long hi,
                                           Src src) {
  df_t acc = {0.0f, 0.0f};
  for (int w = 0; w < offs.n_diags; ++w) {
    const long long j = i + offs.off[w];
    const long long at = (long long)w * n + i;
    const df_t a = {__ldcs(vh + at), __ldcs(vl + at)};
    const df_t x = (j >= lo && j < hi) ? src(j) : df_t{0.0f, 0.0f};
    acc = df_fma(acc, a, x);
  }
  return acc;
}

// --- compensated dots ----------------------------------------------------
//
// A thread's term of (u, v) is the exact product of the hi parts with the
// cross terms added to its error (ops/precision.df_dot). Terms combine as
// in the pairwise df_sum: two_sum of the hi parts, the lo parts and the
// error added, left unnormalised until the end; no flat float sum, which
// would bring back ~1e-7 relative error. The trees' shapes depend only on
// blockDim and G, and there are no float atomics, so the same inputs
// always give the same bits.

__device__ __forceinline__ df_t dot_term(df_t u, df_t v) {
  const df_t p = two_prod(u.hi, v.hi);
  return {p.hi, __fadd_rn(p.lo, df_cross(u, v))};
}

__device__ __forceinline__ df_t dot_add(df_t a, df_t b) {
  const df_t s = two_sum(a.hi, b.hi);
  return {s.hi, __fadd_rn(__fadd_rn(a.lo, b.lo), s.lo)};
}

__device__ __forceinline__ df_t shfl_down_df(df_t v, int d) {
  return {__shfl_down_sync(0xffffffffu, v.hi, d),
          __shfl_down_sync(0xffffffffu, v.lo, d)};
}

// Block reduction of K DF values per thread: warp shuffles, then one warp
// over the per-warp sums. Thread 0 ends with the block's sums in v. Every
// thread of the block must call it.
template <int K>
__device__ __forceinline__ void block_reduce_df(df_t (&v)[K]) {
  __shared__ float warp_hi[K][32], warp_lo[K][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      v[k] = dot_add(v[k], shfl_down_df(v[k], d));
    if (lane == 0) {
      warp_hi[k][warp] = v[k].hi;
      warp_lo[k][warp] = v[k].lo;
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      df_t t = lane < n_warps ? df_t{warp_hi[k][lane], warp_lo[k][lane]}
                              : df_t{0.0f, 0.0f};
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) t = dot_add(t, shfl_down_df(t, d));
      v[k] = t;
    }
  }
}

// The end of a row pass: the block's K partial dots into its row of the
// [G, K, 2] (hi, lo) partials.
template <int K>
__device__ __forceinline__ void store_partials_df(df_t (&v)[K],
                                                  float* __restrict__ part) {
  block_reduce_df<K>(v);
  if (threadIdx.x == 0) {
    float* row = part + 2LL * K * blockIdx.x;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      row[2 * k] = v[k].hi;
      row[2 * k + 1] = v[k].lo;
    }
  }
}

// --- scalars folded into the finishing stage ---------------------------
//
// A DF scalar travels as (hi, lo) pointers to 0-d tensors. A finishing
// stage that folds m scalars writes them into a [2, m] tensor, row 0 the
// hi parts: scalar j at out[j] (hi) and out[m + j] (lo).

__device__ __forceinline__ df_t ld_scalar(const float* h, const float* l) {
  return {*h, *l};
}

__device__ __forceinline__ void st_folded(float* out, int m, int j,
                                          df_t v) {
  out[j] = v.hi;
  out[m + j] = v.lo;
}

// No scalar folded into the finishing stage.
struct NoFold {
  __device__ void operator()(const df_t*) const {}
};

struct FoldAlpha {  // alpha = rTr / (r^, s')
  const float* rtr_h;
  const float* rtr_l;
  float* out;
  __device__ void operator()(const df_t* d) const {
    st_folded(out, 1, 0, df_div(ld_scalar(rtr_h, rtr_l), d[0]));
  }
};

struct FoldOmega {  // omega = (q, y) / (y, y)
  float* out;
  __device__ void operator()(const df_t* d) const {
    st_folded(out, 1, 0, df_div(d[0], d[1]));
  }
};

// The end of a CA or pipelined iteration, from its five dots
// d = (r', r'), (r^, r'), (r^, w'), (r^, s'), (r^, z'), in this order:
//   beta   = (alpha / omega) ((r^, r') / rTr)
//   alpha' = (r^, r') / ((r^, w') + beta ((r^, s') - omega (r^, z')))
// (reference solver.c:248-249 and 387-388), written as the twins' DF
// operators nest it: a - b is df_add(a, df_neg(b)), * df_mul, / df_div.
struct FoldBetaAlpha {
  const float* alpha_h;
  const float* alpha_l;
  const float* omega_h;
  const float* omega_l;
  const float* rtr_h;
  const float* rtr_l;
  float* out;  // [2, 2]: beta, alpha'
  __device__ void operator()(const df_t* d) const {
    const df_t alpha = ld_scalar(alpha_h, alpha_l);
    const df_t omega = ld_scalar(omega_h, omega_l);
    const df_t beta = df_mul(df_div(alpha, omega),
                             df_div(d[1], ld_scalar(rtr_h, rtr_l)));
    const df_t den = df_add(
        d[2], df_mul(beta, df_add(d[3], df_neg(df_mul(omega, d[4])))));
    st_folded(out, 2, 0, beta);
    st_folded(out, 2, 1, df_div(d[1], den));
  }
};

// Second stage of every DF dot: one block sums the [G, K, 2] partials in a
// fixed order (thread t takes rows t, t + blockDim, ...), reduces the
// block, renormalises (df_renorm) and writes dots[2, K] (row 0 hi, row 1
// lo). Thread 0 then hands the K dots to `fold`, which may compute the
// solver's next scalar from them on the device.
template <int K, typename Fold>
__global__ void __launch_bounds__(MBT_FIN_BLOCK)
    sum_partials_df(const float* __restrict__ partials, long long G,
                    float* __restrict__ dots, Fold fold) {
  df_t v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = {0.0f, 0.0f};
  for (long long g = threadIdx.x; g < G; g += blockDim.x) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      v[k] = dot_add(v[k], {partials[(g * K + k) * 2],
                            partials[(g * K + k) * 2 + 1]});
  }
  block_reduce_df<K>(v);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = two_sum(v[k].hi, v[k].lo);
      dots[k] = v[k].hi;
      dots[K + k] = v[k].lo;
    }
    fold(v);
  }
}

// After a DF row pass's launch: report a refused launch, else launch the
// fixed-order sum of its G partial rows (and the fold) on the same stream.
template <int K, typename Fold>
static cudaError_t mbt_finish_df(const float* partials, long long G,
                                 float* dots, Fold fold,
                                 cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_df<K, Fold><<<1, MBT_FIN_BLOCK, 0, stream>>>(partials, G,
                                                            dots, fold);
  return cudaGetLastError();
}
