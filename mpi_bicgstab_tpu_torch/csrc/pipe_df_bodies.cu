// The two iteration bodies of pipelined BiCGStab in double-float (DF)
// arithmetic, without the SpMVs (reference solver.c:351-388 update order):
//
//   body A:  p' = r + beta (p - omega s)
//            s' = w + beta (s - omega z)
//            z' = t + beta (z - omega v)
//            q  = r - alpha s',  y = w - alpha z'     partials (q, y), (y, y)
//   [SpMV]   v' = A z'                                (the caller's)
//   body B:  x' = (x + alpha p') + omega' q
//            r' = q - omega' y
//            w' = y - omega' (t - alpha v')         partials (r', r'),
//                                                    (r^, r'), (r^, w'),
//                                                    (r^, s'), (r^, z')
//   [SpMV]   t' = A w'                                (the caller's)
//
// Replaces: mpi_bicgstab_tpu/ops/pallas_fused_pipe_df.py::_body_a_kernel
// and ::_body_b_kernel (wrappers fused_body_a, fused_body_b). Those run
// over [64, 128] tiles of the 8192-row padded grid and pack per-tile DF
// partials into lane slots. Here one thread owns one row of any n, the
// vectors are plain (hi, lo) arrays, and each block writes its
// compensated partials for the fixed-order second stage of df_core.cuh.
// The dots stay local: the caller completes them through its Comm (an
// identity on one device, a sum across ranks in a distributed solve), and
// folds omega' and (beta', alpha') itself, as the JAX solver does; no
// scalar is folded here.
//
// Bound on the H100: memory. Body A reads 7 DF vectors and writes 5, body
// B reads 9 and writes 3: 96 B/row each, 153.8 MB at n = 1,601,613
// (0.0459 ms at 3.35 TB/s). The arithmetic, eight (A) or five (B) df_fma
// and two or five compensated dot terms per row, is ~0.4 GFLOP (6 us at
// 67 TFLOP/s).
//
// Exactness: df_core.cuh helpers only, in the twin's nesting
// (ops/cuda_pipe_df_bodies.py *_plain); output vectors equal the twin's bit
// for bit, dots lie within ~1e-15 sum |u_i v_i| of its pairwise df_sum.
// Every output goes to a fresh buffer.
#include "df_core.cuh"

__global__ void __launch_bounds__(MBT_BLOCK)
    body_a_kernel(long long n, const float* __restrict__ rh,
                  const float* __restrict__ rl,
                  const float* __restrict__ ph,
                  const float* __restrict__ pl,
                  const float* __restrict__ sh,
                  const float* __restrict__ sl,
                  const float* __restrict__ wh,
                  const float* __restrict__ wl,
                  const float* __restrict__ zh,
                  const float* __restrict__ zl,
                  const float* __restrict__ th,
                  const float* __restrict__ tl,
                  const float* __restrict__ v_h,
                  const float* __restrict__ v_l,
                  const float* __restrict__ alpha_h,
                  const float* __restrict__ alpha_l,
                  const float* __restrict__ beta_h,
                  const float* __restrict__ beta_l,
                  const float* __restrict__ omega_h,
                  const float* __restrict__ omega_l,
                  float* __restrict__ p2h, float* __restrict__ p2l,
                  float* __restrict__ s2h, float* __restrict__ s2l,
                  float* __restrict__ z2h, float* __restrict__ z2l,
                  float* __restrict__ qh, float* __restrict__ ql,
                  float* __restrict__ yh, float* __restrict__ yl,
                  float* __restrict__ partials) {
  const df_t beta = ld_scalar(beta_h, beta_l);
  const df_t neg_alpha = df_neg(ld_scalar(alpha_h, alpha_l));
  const df_t neg_omega = df_neg(ld_scalar(omega_h, omega_l));
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  df_t part[2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  if (i < n) {
    const df_t r = ld_df(rh, rl, i);
    const df_t s = ld_df(sh, sl, i);
    const df_t w = ld_df(wh, wl, i);
    const df_t z = ld_df(zh, zl, i);
    const df_t p2 = df_fma(r, beta, df_fma(ld_df(ph, pl, i), neg_omega, s));
    const df_t s2 = df_fma(w, beta, df_fma(s, neg_omega, z));
    const df_t z2 = df_fma(ld_df(th, tl, i), beta,
                           df_fma(z, neg_omega, ld_df(v_h, v_l, i)));
    const df_t q = df_fma(r, neg_alpha, s2);
    const df_t y = df_fma(w, neg_alpha, z2);
    st_df(p2h, p2l, i, p2);
    st_df(s2h, s2l, i, s2);
    st_df(z2h, z2l, i, z2);
    st_df(qh, ql, i, q);
    st_df(yh, yl, i, y);
    part[0] = dot_term(q, y);
    part[1] = dot_term(y, y);
  }
  store_partials_df<2>(part, partials);
}

__global__ void __launch_bounds__(MBT_BLOCK)
    body_b_kernel(long long n, const float* __restrict__ xh,
                  const float* __restrict__ xl,
                  const float* __restrict__ p2h,
                  const float* __restrict__ p2l,
                  const float* __restrict__ qh,
                  const float* __restrict__ ql,
                  const float* __restrict__ yh,
                  const float* __restrict__ yl,
                  const float* __restrict__ th,
                  const float* __restrict__ tl,
                  const float* __restrict__ v2h,
                  const float* __restrict__ v2l,
                  const float* __restrict__ rhh,
                  const float* __restrict__ rhl,
                  const float* __restrict__ s2h,
                  const float* __restrict__ s2l,
                  const float* __restrict__ z2h,
                  const float* __restrict__ z2l,
                  const float* __restrict__ alpha_h,
                  const float* __restrict__ alpha_l,
                  const float* __restrict__ omega_h,
                  const float* __restrict__ omega_l,
                  float* __restrict__ x2h, float* __restrict__ x2l,
                  float* __restrict__ r2h, float* __restrict__ r2l,
                  float* __restrict__ w2h, float* __restrict__ w2l,
                  float* __restrict__ partials) {
  const df_t alpha = ld_scalar(alpha_h, alpha_l);
  const df_t omega = ld_scalar(omega_h, omega_l);
  const df_t neg_alpha = df_neg(alpha);
  const df_t neg_omega = df_neg(omega);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  df_t part[5] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f},
                  {0.0f, 0.0f}};
  if (i < n) {
    const df_t q = ld_df(qh, ql, i);
    const df_t y = ld_df(yh, yl, i);
    const df_t x2 = df_fma(df_fma(ld_df(xh, xl, i), alpha, ld_df(p2h, p2l, i)),
                           omega, q);
    const df_t r2 = df_fma(q, neg_omega, y);
    const df_t w2 = df_fma(y, neg_omega,
                           df_fma(ld_df(th, tl, i), neg_alpha,
                                  ld_df(v2h, v2l, i)));
    st_df(x2h, x2l, i, x2);
    st_df(r2h, r2l, i, r2);
    st_df(w2h, w2l, i, w2);
    const df_t rhat = ld_df(rhh, rhl, i);
    part[0] = dot_term(r2, r2);
    part[1] = dot_term(rhat, r2);
    part[2] = dot_term(rhat, w2);
    part[3] = dot_term(rhat, ld_df(s2h, s2l, i));
    part[4] = dot_term(rhat, ld_df(z2h, z2l, i));
  }
  store_partials_df<5>(part, partials);
}

extern "C" {

// partials: [mbt_grid(n), 2, 2] scratch; dots: [2, 2] = (q, y), (y, y).
cudaError_t mbt_pipe_df_body_a(long long n, const float* rh, const float* rl,
                               const float* ph, const float* pl,
                               const float* sh, const float* sl,
                               const float* wh, const float* wl,
                               const float* zh, const float* zl,
                               const float* th, const float* tl,
                               const float* v_h, const float* v_l,
                               const float* alpha_h, const float* alpha_l,
                               const float* beta_h, const float* beta_l,
                               const float* omega_h, const float* omega_l,
                               float* p2h, float* p2l, float* s2h, float* s2l,
                               float* z2h, float* z2l, float* qh, float* ql,
                               float* yh, float* yl, float* partials,
                               float* dots, cudaStream_t stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const long long G = mbt_grid(n);
  body_a_kernel<<<G, MBT_BLOCK, 0, stream>>>(
      n, rh, rl, ph, pl, sh, sl, wh, wl, zh, zl, th, tl, v_h, v_l, alpha_h,
      alpha_l, beta_h, beta_l, omega_h, omega_l, p2h, p2l, s2h, s2l, z2h,
      z2l, qh, ql, yh, yl, partials);
  return mbt_finish_df<2>(partials, G, dots, NoFold{}, stream);
}

// partials: [mbt_grid(n), 5, 2] scratch; dots: [2, 5] = (r', r'),
// (r^, r'), (r^, w'), (r^, s'), (r^, z').
cudaError_t mbt_pipe_df_body_b(long long n, const float* xh, const float* xl,
                               const float* p2h, const float* p2l,
                               const float* qh, const float* ql,
                               const float* yh, const float* yl,
                               const float* th, const float* tl,
                               const float* v2h, const float* v2l,
                               const float* rhh, const float* rhl,
                               const float* s2h, const float* s2l,
                               const float* z2h, const float* z2l,
                               const float* alpha_h, const float* alpha_l,
                               const float* omega_h, const float* omega_l,
                               float* x2h, float* x2l, float* r2h, float* r2l,
                               float* w2h, float* w2l, float* partials,
                               float* dots, cudaStream_t stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const long long G = mbt_grid(n);
  body_b_kernel<<<G, MBT_BLOCK, 0, stream>>>(
      n, xh, xl, p2h, p2l, qh, ql, yh, yl, th, tl, v2h, v2l, rhh, rhl, s2h,
      s2l, z2h, z2l, alpha_h, alpha_l, omega_h, omega_l, x2h, x2l, r2h, r2l,
      w2h, w2l, partials);
  return mbt_finish_df<5>(partials, G, dots, NoFold{}, stream);
}

}  // extern "C"
