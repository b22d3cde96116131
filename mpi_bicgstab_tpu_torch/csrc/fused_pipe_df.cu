// The two phases of one fully fused pipelined-BiCGStab iteration in
// double-float (DF) arithmetic (reference solver.c:351-388 update order).
// Each phase multiplies a stored vector and forms the other phase's SpMV
// input itself, so no vector operation runs between the phases:
//
//   phase A: t  = A w
//            z' = t + beta (z - omega v)
//            p' = r + beta (p - omega s)
//            s' = w + beta (s - omega z)      the OLD z
//            q  = r - alpha s',  y = w - alpha z'
//                                             partials (q, y), (y, y);
//                                             omega' = (q, y) / (y, y)
//   phase B: v' = A z'
//            w' = y - omega' (t - alpha v')
//            x' = (x + alpha p') + omega' q
//            r' = q - omega' y                partials (r',r'), (r^,r'),
//                                             (r^,w'), (r^,s'), (r^,z');
//            beta' = (alpha / omega') ((r^, r') / rTr)
//            alpha' = (r^, r') / ((r^, w') + beta' ((r^, s') - omega' (r^, z')))
//
// This is the JAX package's DF layout (phase A multiplies the stored w,
// phase B phase A's z'), not the float32 port's (fused_pipe.cu), which
// forms z' and w' with tensor operations between its phases.
//
// Replaces: mpi_bicgstab_tpu/ops/pallas_fused_pipe_df2.py::_phase_a_kernel
// and ::_phase_b_kernel (wrappers fused_phase_a_full / fused_phase_b_full).
// Those DMA a chunk-plus-halo window of the SpMV input into VMEM and
// stream tiles of the other vectors past it. Here each thread owns one
// row and reads its W neighbours of the SpMV input directly (L2 hits):
// unlike the CA and classic passes, nothing is recomputed.
//
// Bound on the H100: memory. At n = 1,602,112, W = 15 and 8 bytes per DF
// element the least traffic is the band (192.3 MB) plus each vector once:
// phase A reads 6 and writes 6, phase B reads 8 and writes 4, 346.1 MB
// each, a 103.3 us floor at 3.35 TB/s. The arithmetic, one df_fma per
// band entry plus five updates and the dots per row, is ~0.5 GFLOP
// (8 us at 67 TFLOP/s).
//
// Exactness: df_core.cuh helpers only, in the twin's order and nesting
// (ops/cuda_fused_pipe_df.py *_plain): w' = df_fma(y, -omega',
// df_fma(t, -alpha, v')), x' = df_fma(df_fma(x, alpha, p'), omega', q).
// Output vectors equal the twin's bit for bit.
//
// Scalars never leave the device: phase A's finishing stage folds omega'
// (FoldOmega), phase B's beta' and then alpha' (FoldBetaAlpha), so one
// iteration is four launches.
//
// Hazards: other blocks read w (phase A) or z' (phase B) at their halo
// rows while a phase runs, so every output goes to a fresh buffer; the
// dots reduce in a fixed order with no float atomics.
#include "df_core.cuh"

__global__ void __launch_bounds__(MBT_BLOCK)
    phase_a_df_kernel(const __grid_constant__ DiaOffsets offs, long long n,
                      const float* __restrict__ vh,
                      const float* __restrict__ vl,
                      const float* __restrict__ wh,
                      const float* __restrict__ wl,
                      const float* __restrict__ rh,
                      const float* __restrict__ rl,
                      const float* __restrict__ ph,
                      const float* __restrict__ pl,
                      const float* __restrict__ sh,
                      const float* __restrict__ sl,
                      const float* __restrict__ zh,
                      const float* __restrict__ zl,
                      const float* __restrict__ v_h,
                      const float* __restrict__ v_l,
                      const float* __restrict__ alpha_h,
                      const float* __restrict__ alpha_l,
                      const float* __restrict__ beta_h,
                      const float* __restrict__ beta_l,
                      const float* __restrict__ omega_h,
                      const float* __restrict__ omega_l,
                      float* __restrict__ th, float* __restrict__ tl,
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
    const df_t t = dia_row_df(offs, vh, vl, n, i, WholeSrcDF{wh, wl});
    const df_t w = ld_df(wh, wl, i);
    const df_t r = ld_df(rh, rl, i);
    const df_t s = ld_df(sh, sl, i);
    const df_t z = ld_df(zh, zl, i);
    const df_t z2 = df_fma(t, beta, df_fma(z, neg_omega, ld_df(v_h, v_l, i)));
    const df_t p2 = df_fma(r, beta, df_fma(ld_df(ph, pl, i), neg_omega, s));
    const df_t s2 = df_fma(w, beta, df_fma(s, neg_omega, z));
    const df_t q = df_fma(r, neg_alpha, s2);
    const df_t y = df_fma(w, neg_alpha, z2);
    st_df(th, tl, i, t);
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
    phase_b_df_kernel(const __grid_constant__ DiaOffsets offs, long long n,
                      const float* __restrict__ vh,
                      const float* __restrict__ vl,
                      const float* __restrict__ z2h,
                      const float* __restrict__ z2l,
                      const float* __restrict__ xh,
                      const float* __restrict__ xl,
                      const float* __restrict__ p2h,
                      const float* __restrict__ p2l,
                      const float* __restrict__ qh,
                      const float* __restrict__ ql,
                      const float* __restrict__ yh,
                      const float* __restrict__ yl,
                      const float* __restrict__ th,
                      const float* __restrict__ tl,
                      const float* __restrict__ rhh,
                      const float* __restrict__ rhl,
                      const float* __restrict__ s2h,
                      const float* __restrict__ s2l,
                      const float* __restrict__ alpha_h,
                      const float* __restrict__ alpha_l,
                      const float* __restrict__ omega_h,
                      const float* __restrict__ omega_l,
                      float* __restrict__ v2h, float* __restrict__ v2l,
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
    const df_t v2 = dia_row_df(offs, vh, vl, n, i, WholeSrcDF{z2h, z2l});
    const df_t q = ld_df(qh, ql, i);
    const df_t y = ld_df(yh, yl, i);
    const df_t w2 =
        df_fma(y, neg_omega, df_fma(ld_df(th, tl, i), neg_alpha, v2));
    const df_t x2 = df_fma(df_fma(ld_df(xh, xl, i), alpha, ld_df(p2h, p2l, i)),
                           omega, q);
    const df_t r2 = df_fma(q, neg_omega, y);
    st_df(v2h, v2l, i, v2);
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

// partials: [mbt_grid(n), 2, 2] scratch; dots: [2, 2] = (q, y), (y, y);
// omega: [2, 1] = (q, y) / (y, y).
cudaError_t mbt_phase_a_df(const int* offsets, int n_diags, long long n,
                           const float* vh, const float* vl, const float* wh,
                           const float* wl, const float* rh, const float* rl,
                           const float* ph, const float* pl, const float* sh,
                           const float* sl, const float* zh, const float* zl,
                           const float* v_h, const float* v_l,
                           const float* alpha_h, const float* alpha_l,
                           const float* beta_h, const float* beta_l,
                           const float* omega_h, const float* omega_l,
                           float* th, float* tl, float* p2h, float* p2l,
                           float* s2h, float* s2l, float* z2h, float* z2l,
                           float* qh, float* ql, float* yh, float* yl,
                           float* partials, float* dots, float* omega,
                           cudaStream_t stream) {
  DiaOffsets o;
  if (n < 1 || !mbt_fill_offsets(o, offsets, n_diags))
    return cudaErrorInvalidValue;
  const long long G = mbt_grid(n);
  phase_a_df_kernel<<<G, MBT_BLOCK, 0, stream>>>(
      o, n, vh, vl, wh, wl, rh, rl, ph, pl, sh, sl, zh, zl, v_h, v_l,
      alpha_h, alpha_l, beta_h, beta_l, omega_h, omega_l, th, tl, p2h, p2l,
      s2h, s2l, z2h, z2l, qh, ql, yh, yl, partials);
  return mbt_finish_df<2>(partials, G, dots, FoldOmega{omega}, stream);
}

// partials: [mbt_grid(n), 5, 2] scratch; dots: [2, 5] = (r', r'),
// (r^, r'), (r^, w'), (r^, s'), (r^, z'); folded: [2, 2] = beta, alpha'
// (FoldBetaAlpha, with the rTr of the iteration's start).
cudaError_t mbt_phase_b_df(const int* offsets, int n_diags, long long n,
                           const float* vh, const float* vl,
                           const float* z2h, const float* z2l,
                           const float* xh, const float* xl,
                           const float* p2h, const float* p2l,
                           const float* qh, const float* ql,
                           const float* yh, const float* yl,
                           const float* th, const float* tl,
                           const float* rhh, const float* rhl,
                           const float* s2h, const float* s2l,
                           const float* alpha_h, const float* alpha_l,
                           const float* omega_h, const float* omega_l,
                           const float* rtr_h, const float* rtr_l,
                           float* v2h, float* v2l, float* x2h, float* x2l,
                           float* r2h, float* r2l, float* w2h, float* w2l,
                           float* partials, float* dots, float* folded,
                           cudaStream_t stream) {
  DiaOffsets o;
  if (n < 1 || !mbt_fill_offsets(o, offsets, n_diags))
    return cudaErrorInvalidValue;
  const long long G = mbt_grid(n);
  phase_b_df_kernel<<<G, MBT_BLOCK, 0, stream>>>(
      o, n, vh, vl, z2h, z2l, xh, xl, p2h, p2l, qh, ql, yh, yl, th, tl, rhh,
      rhl, s2h, s2l, alpha_h, alpha_l, omega_h, omega_l, v2h, v2l, x2h, x2l,
      r2h, r2l, w2h, w2l, partials);
  return mbt_finish_df<5>(partials, G, dots,
                          FoldBetaAlpha{alpha_h, alpha_l, omega_h, omega_l,
                                        rtr_h, rtr_l, folded},
                          stream);
}

}  // extern "C"
