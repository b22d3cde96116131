// The iteration bodies of classic BiCGStab in double-float (DF) arithmetic
// around an operator the caller applies (reference solver.c:88-119 update
// order, that of solvers/bicgstab.bicgstab):
//
//   [op]     s  = op(p)                            (the caller's)
//   pass A:  nothing stored                        partial (r^, s);
//                                                  alpha = rTr / (r^, s)
//   pass Q:  q  = r - alpha s
//   [op]     y  = op(q)                            (the caller's)
//   pass O:  nothing stored                        partials (q, y), (y, y);
//                                                  omega = (q, y) / (y, y)
//   pass X:  x' = (x + alpha p) + omega q,  r' = q - omega y
//                                                  partials (r', r'),
//                                                  (r^, r'); beta = (alpha /
//                                                  omega) ((r^, r') / rTr)
//   pass P:  p' = r' + beta (p - omega s)
//
// Pass X is kernel 11 (fused_classic_df.cu, k3_df_kernel), which is
// pointwise already; this file holds the other four.
//
// Replaces no Pallas kernel: the JAX package runs this loop
// (mpi_bicgstab_tpu/solvers/bicgstab.py:145-157) through XLA, which fuses
// the DF vector ops, dots and scalar algebra on its own. Run as separate
// PyTorch ops they were ~1,500 launches an iteration; with these passes an
// iteration is five passes and three finishing stages beside the
// operator's launches.
//
// One thread owns one row of any n, the vectors are plain (hi, lo) arrays,
// and each pass with dots writes its blocks' compensated partials for the
// fixed-order second stage of df_core.cuh, whose thread 0 then folds the
// next scalar on the card (FoldAlpha, FoldOmega), as kernels 9-11 do. The
// dots are the rank's own: in a row-partitioned solve the caller reduces
// them through its Comm and forms the scalar from the reduced ones, and
// the folded value goes unused, as in the halo form of kernels 9-11.
//
// Bound on the H100: memory. Per row, P reads 3 DF vectors and writes 1
// (32 B), A reads 2 (16 B), Q reads 2 and writes 1 (24 B), O reads 2
// (16 B): 51.3, 25.6, 38.4 and 25.6 MB at n = 1,601,613, floors of 15.3,
// 7.6, 11.5 and 7.6 us at 3.35 TB/s. The arithmetic, at most two df_fma
// and two compensated dot terms per row, is negligible.
//
// Exactness: df_core.cuh helpers only, in the twins' nesting
// (ops/cuda_classic_df_bodies.py *_plain, which are the unfused solver's
// DF steps); output vectors and folded scalars from equal dots equal the
// twin's bit for bit, dots lie within ~1e-15 sum |u_i v_i| of its
// pairwise df_sum. Every output goes to a fresh buffer.
//
// Each launcher runs its pass (and the finishing stage) on `stream` and
// returns cudaGetLastError().
#include "df_core.cuh"

__global__ void __launch_bounds__(MBT_BLOCK)
    p_kernel(long long n, const float* __restrict__ rh,
             const float* __restrict__ rl, const float* __restrict__ ph,
             const float* __restrict__ pl, const float* __restrict__ sh,
             const float* __restrict__ sl, const float* __restrict__ beta_h,
             const float* __restrict__ beta_l,
             const float* __restrict__ omega_h,
             const float* __restrict__ omega_l, float* __restrict__ p2h,
             float* __restrict__ p2l) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const df_t beta = ld_scalar(beta_h, beta_l);
  const df_t neg_omega = df_neg(ld_scalar(omega_h, omega_l));
  st_df(p2h, p2l, i,
        df_fma(ld_df(rh, rl, i), beta,
               df_fma(ld_df(ph, pl, i), neg_omega, ld_df(sh, sl, i))));
}

__global__ void __launch_bounds__(MBT_BLOCK)
    a_kernel(long long n, const float* __restrict__ rhh,
             const float* __restrict__ rhl, const float* __restrict__ sh,
             const float* __restrict__ sl, float* __restrict__ partials) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  df_t part[1] = {{0.0f, 0.0f}};
  if (i < n) part[0] = dot_term(ld_df(rhh, rhl, i), ld_df(sh, sl, i));
  store_partials_df<1>(part, partials);
}

__global__ void __launch_bounds__(MBT_BLOCK)
    q_kernel(long long n, const float* __restrict__ rh,
             const float* __restrict__ rl, const float* __restrict__ sh,
             const float* __restrict__ sl,
             const float* __restrict__ alpha_h,
             const float* __restrict__ alpha_l, float* __restrict__ qh,
             float* __restrict__ ql) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const df_t neg_alpha = df_neg(ld_scalar(alpha_h, alpha_l));
  st_df(qh, ql, i, df_fma(ld_df(rh, rl, i), neg_alpha, ld_df(sh, sl, i)));
}

__global__ void __launch_bounds__(MBT_BLOCK)
    o_kernel(long long n, const float* __restrict__ qh,
             const float* __restrict__ ql, const float* __restrict__ yh,
             const float* __restrict__ yl, float* __restrict__ partials) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  df_t part[2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  if (i < n) {
    const df_t y = ld_df(yh, yl, i);
    part[0] = dot_term(ld_df(qh, ql, i), y);
    part[1] = dot_term(y, y);
  }
  store_partials_df<2>(part, partials);
}

extern "C" {

// p' = r + beta (p - omega s); no dots.
cudaError_t mbt_classic_df_p(long long n, const float* rh, const float* rl,
                             const float* ph, const float* pl,
                             const float* sh, const float* sl,
                             const float* beta_h, const float* beta_l,
                             const float* omega_h, const float* omega_l,
                             float* p2h, float* p2l, cudaStream_t stream) {
  if (n < 1) return cudaErrorInvalidValue;
  p_kernel<<<mbt_grid(n), MBT_BLOCK, 0, stream>>>(
      n, rh, rl, ph, pl, sh, sl, beta_h, beta_l, omega_h, omega_l, p2h, p2l);
  return cudaGetLastError();
}

// partials: [mbt_grid(n), 1, 2] scratch; dots: [2, 1] = (r^, s);
// alpha: [2] = rTr / (r^, s).
cudaError_t mbt_classic_df_a(long long n, const float* rhh, const float* rhl,
                             const float* sh, const float* sl,
                             const float* rtr_h, const float* rtr_l,
                             float* partials, float* dots, float* alpha,
                             cudaStream_t stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const long long G = mbt_grid(n);
  a_kernel<<<G, MBT_BLOCK, 0, stream>>>(n, rhh, rhl, sh, sl, partials);
  return mbt_finish_df<1>(partials, G, dots, FoldAlpha{rtr_h, rtr_l, alpha},
                          stream);
}

// q = r - alpha s; no dots.
cudaError_t mbt_classic_df_q(long long n, const float* rh, const float* rl,
                             const float* sh, const float* sl,
                             const float* alpha_h, const float* alpha_l,
                             float* qh, float* ql, cudaStream_t stream) {
  if (n < 1) return cudaErrorInvalidValue;
  q_kernel<<<mbt_grid(n), MBT_BLOCK, 0, stream>>>(n, rh, rl, sh, sl, alpha_h,
                                                  alpha_l, qh, ql);
  return cudaGetLastError();
}

// partials: [mbt_grid(n), 2, 2] scratch; dots: [2, 2] = (q, y), (y, y);
// omega: [2] = (q, y) / (y, y).
cudaError_t mbt_classic_df_o(long long n, const float* qh, const float* ql,
                             const float* yh, const float* yl,
                             float* partials, float* dots, float* omega,
                             cudaStream_t stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const long long G = mbt_grid(n);
  o_kernel<<<G, MBT_BLOCK, 0, stream>>>(n, qh, ql, yh, yl, partials);
  return mbt_finish_df<2>(partials, G, dots, FoldOmega{omega}, stream);
}

}  // extern "C"
