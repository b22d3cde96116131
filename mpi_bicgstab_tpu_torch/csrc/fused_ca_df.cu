// The two passes of one fused CA-BiCGStab iteration in double-float (DF)
// arithmetic (reference solver.c:160-278 update order; the DF form of
// fused_ca.cu):
//
//   K1: p' = r + beta (p - omega s)
//       s' = w + beta (s - omega z)    recomputed at every neighbour
//       z' = A s'
//       q  = r - alpha s',  y = w - alpha z'
//                                      partials (q, y), (y, y);
//                                      omega' = (q, y) / (y, y)
//   K2: r' = q - omega' y              recomputed at every neighbour
//       w' = A r'
//       x' = (x + alpha p') + omega' q
//                                      partials (r',r'), (r^,r'), (r^,w'),
//                                      (r^,s'), (r^,z');
//       beta' = (alpha / omega') ((r^, r') / rTr)
//       alpha' = (r^, r') / ((r^, w') + beta' ((r^, s') - omega' (r^, z')))
//
// Replaces: mpi_bicgstab_tpu/ops/pallas_fused_ca_df.py::_k1_kernel and
// ::_k2_kernel (wrappers fused_ca_k1_df / fused_ca_k2_df). Those DMA a
// chunk of rows plus the band halo of each DF source vector into VMEM
// and form s' or r' over the whole window once per chunk. Here, as in
// fused_classic_df.cu, each thread owns one row and recomputes the SpMV
// input at each of its W neighbours straight from the source vectors.
//
// Bound on the H100: memory, by the byte count. At n = 1,602,112, W = 15
// and 8 bytes per DF element the least traffic is the band (192.3 MB)
// plus each vector once: K1 reads 5 vectors and writes 5, K2 reads 7 and
// writes 3, 320.4 MB each, a floor of 95.6 us at 3.35 TB/s. The least
// arithmetic is one df_fma (18 float operations) per band entry plus the
// updates and dots, about 0.5 GFLOP per pass (8 us at 67 TFLOP/s). On
// top of that this simple design recomputes s' (two df_fma, 6 floats
// read from L2) or r' (one df_fma, 4 floats) at every neighbour, as DF
// K1 and K2 recompute p' and q; those ran at 71-72% of their byte floors.
//
// Exactness: every DF operation is a df_core.cuh helper written with
// non-contracting intrinsics, in the plain twin's order
// (ops/cuda_fused_ca_df.py *_plain), so every output vector equals the
// twin's bit for bit and a recomputed s' or r' equals the stored one.
// Out-of-range neighbours are never read (dia_row_df).
//
// Scalars never leave the device: K1's finishing stage folds omega'
// (FoldOmega), K2's folds beta' and then alpha' (FoldBetaAlpha), so one
// iteration is four launches.
//
// Hazards: other blocks read w, s and z (K1) or q and y (K2) at their
// halo rows while a pass runs, so every output goes to a fresh buffer;
// the dots reduce in a fixed order with no float atomics.
#include "df_core.cuh"

struct CaK1SrcDF {  // s'(j) = w[j] + beta (s[j] - omega z[j])
  const float* __restrict__ wh;
  const float* __restrict__ wl;
  const float* __restrict__ sh;
  const float* __restrict__ sl;
  const float* __restrict__ zh;
  const float* __restrict__ zl;
  df_t beta, neg_omega;
  __device__ __forceinline__ df_t operator()(long long j) const {
    return df_fma(ld_df(wh, wl, j), beta,
                  df_fma(ld_df(sh, sl, j), neg_omega, ld_df(zh, zl, j)));
  }
};

struct CaK2SrcDF {  // r'(j) = q[j] - omega y[j]
  const float* __restrict__ qh;
  const float* __restrict__ ql;
  const float* __restrict__ yh;
  const float* __restrict__ yl;
  df_t neg_omega;
  __device__ __forceinline__ df_t operator()(long long j) const {
    return df_fma(ld_df(qh, ql, j), neg_omega, ld_df(yh, yl, j));
  }
};

__global__ void __launch_bounds__(MBT_BLOCK)
    ca_k1_df_kernel(const __grid_constant__ DiaOffsets offs, long long n,
                    const float* __restrict__ vh,
                    const float* __restrict__ vl,
                    const float* __restrict__ rh,
                    const float* __restrict__ rl,
                    const float* __restrict__ ph,
                    const float* __restrict__ pl,
                    const float* __restrict__ sh,
                    const float* __restrict__ sl,
                    const float* __restrict__ wh,
                    const float* __restrict__ wl,
                    const float* __restrict__ zh,
                    const float* __restrict__ zl,
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
  const CaK1SrcDF src{wh, wl, sh, sl, zh, zl, beta, neg_omega};
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  df_t part[2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  if (i < n) {
    const df_t z2 = dia_row_df(offs, vh, vl, n, i, src);
    const df_t s2 = src(i);
    const df_t r = ld_df(rh, rl, i);
    const df_t p2 =
        df_fma(r, beta, df_fma(ld_df(ph, pl, i), neg_omega, ld_df(sh, sl, i)));
    const df_t q = df_fma(r, neg_alpha, s2);
    const df_t y = df_fma(ld_df(wh, wl, i), neg_alpha, z2);
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
    ca_k2_df_kernel(const __grid_constant__ DiaOffsets offs, long long n,
                    const float* __restrict__ vh,
                    const float* __restrict__ vl,
                    const float* __restrict__ qh,
                    const float* __restrict__ ql,
                    const float* __restrict__ yh,
                    const float* __restrict__ yl,
                    const float* __restrict__ xh,
                    const float* __restrict__ xl,
                    const float* __restrict__ p2h,
                    const float* __restrict__ p2l,
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
  const CaK2SrcDF src{qh, ql, yh, yl, df_neg(omega)};
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  df_t part[5] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f},
                  {0.0f, 0.0f}};
  if (i < n) {
    const df_t w2 = dia_row_df(offs, vh, vl, n, i, src);
    const df_t r2 = src(i);
    const df_t x2 = df_fma(df_fma(ld_df(xh, xl, i), alpha, ld_df(p2h, p2l, i)),
                           omega, ld_df(qh, ql, i));
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
cudaError_t mbt_ca_k1_df(const int* offsets, int n_diags, long long n,
                         const float* vh, const float* vl, const float* rh,
                         const float* rl, const float* ph, const float* pl,
                         const float* sh, const float* sl, const float* wh,
                         const float* wl, const float* zh, const float* zl,
                         const float* alpha_h, const float* alpha_l,
                         const float* beta_h, const float* beta_l,
                         const float* omega_h, const float* omega_l,
                         float* p2h, float* p2l, float* s2h, float* s2l,
                         float* z2h, float* z2l, float* qh, float* ql,
                         float* yh, float* yl, float* partials, float* dots,
                         float* omega, cudaStream_t stream) {
  DiaOffsets o;
  if (n < 1 || !mbt_fill_offsets(o, offsets, n_diags))
    return cudaErrorInvalidValue;
  const long long G = mbt_grid(n);
  ca_k1_df_kernel<<<G, MBT_BLOCK, 0, stream>>>(
      o, n, vh, vl, rh, rl, ph, pl, sh, sl, wh, wl, zh, zl, alpha_h, alpha_l,
      beta_h, beta_l, omega_h, omega_l, p2h, p2l, s2h, s2l, z2h, z2l, qh, ql,
      yh, yl, partials);
  return mbt_finish_df<2>(partials, G, dots, FoldOmega{omega}, stream);
}

// partials: [mbt_grid(n), 5, 2] scratch; dots: [2, 5] = (r', r'),
// (r^, r'), (r^, w'), (r^, s'), (r^, z'); folded: [2, 2] = beta, alpha'
// (FoldBetaAlpha, with the rTr of the iteration's start).
cudaError_t mbt_ca_k2_df(const int* offsets, int n_diags, long long n,
                         const float* vh, const float* vl, const float* qh,
                         const float* ql, const float* yh, const float* yl,
                         const float* xh, const float* xl, const float* p2h,
                         const float* p2l, const float* rhh,
                         const float* rhl, const float* s2h,
                         const float* s2l, const float* z2h,
                         const float* z2l, const float* alpha_h,
                         const float* alpha_l, const float* omega_h,
                         const float* omega_l, const float* rtr_h,
                         const float* rtr_l, float* x2h, float* x2l,
                         float* r2h, float* r2l, float* w2h, float* w2l,
                         float* partials, float* dots, float* folded,
                         cudaStream_t stream) {
  DiaOffsets o;
  if (n < 1 || !mbt_fill_offsets(o, offsets, n_diags))
    return cudaErrorInvalidValue;
  const long long G = mbt_grid(n);
  ca_k2_df_kernel<<<G, MBT_BLOCK, 0, stream>>>(
      o, n, vh, vl, qh, ql, yh, yl, xh, xl, p2h, p2l, rhh, rhl, s2h, s2l,
      z2h, z2l, alpha_h, alpha_l, omega_h, omega_l, x2h, x2l, r2h, r2l, w2h,
      w2l, partials);
  return mbt_finish_df<5>(partials, G, dots,
                          FoldBetaAlpha{alpha_h, alpha_l, omega_h, omega_l,
                                        rtr_h, rtr_l, folded},
                          stream);
}

}  // extern "C"
