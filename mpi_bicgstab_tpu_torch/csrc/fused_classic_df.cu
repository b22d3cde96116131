// The three passes of one fused classic-BiCGStab iteration in double-float
// (DF) arithmetic (reference solver.c:86-119 update order, the end-of-loop
// p update deferred into the next iteration's K1, as in fused_classic.cu):
//
//   K1: p' = r + beta (p - omega s)   recomputed at every neighbour
//       s' = A p'                     partial (r^, s');  alpha = rTr/(r^,s')
//   K2: q  = r - alpha s'             recomputed at every neighbour
//       y  = A q                      partials (q, y), (y, y);
//                                     omega = (q,y)/(y,y)
//   K3: x' = (x + alpha p') + omega q pointwise
//       r' = q - omega y              partials (r', r'), (r^, r');
//                                     beta = (alpha/omega)((r^,r')/rTr)
//
// Replaces: mpi_bicgstab_tpu/ops/pallas_fused_classic_df.py::_k1_kernel,
// ::_k2_kernel and ::_k3_kernel (wrappers fused_k1_df / fused_k2_df /
// fused_k3_df). Those DMA a chunk of rows plus the band halo of each DF
// source vector into VMEM and compute p' or q over the whole window. Here,
// as in fused_classic.cu, each thread owns one row and recomputes the SpMV
// input at each of its W neighbours straight from the source vectors.
//
// Bound on the H100: memory, by the byte count. At n = 1,602,112, W = 15
// and 8 bytes per DF element the least traffic is the band (192.3 MB)
// plus each vector once: K1 269.2 MB, K2 243.5 MB, K3 89.7 MB, floors of
// 80.3, 72.7 and 26.8 us at 3.35 TB/s. The least arithmetic is one df_fma
// (18 float operations) per band entry plus the updates and dots, about
// 0.5 GFLOP per pass (8 us at 67 TFLOP/s). The recompute is what this
// simple design pays on top: K1 forms a DF p' (two df_fma) at each of the
// 15 neighbours, ~540 operations per row besides the band's ~270, and
// reads 6 floats per neighbour from L2; it may end up bound by operations
// or by L2 rather than by HBM. That is measured, not redesigned, here.
//
// Exactness: every DF operation is a df_core.cuh helper written with
// non-contracting intrinsics, in the plain twin's order (ops/precision.py
// and ops/cuda_fused_classic_df.py *_plain), so p', s', q, y, x' and r'
// equal the twin's bit for bit, and a recomputed p' or q equals the
// stored one. Out-of-range neighbours are never read (dia_row_df).
//
// Scalars: alpha, beta and omega never leave the device. Each pass's
// one-block finishing stage sums its DF partials and then, on thread 0,
// computes the scalar the next pass needs with the same helpers (the
// "fold"), so one iteration is six launches and no scalar kernels. The
// scalars travel as (hi, lo) pointers to 0-d tensors.
//
// Hazards handled as in fused_classic.cu: outputs go to fresh buffers
// (other blocks read r, p, s and s' at their halo rows while a pass
// runs); dots reduce in a fixed order with no float atomics.
//
// The halo form (solvers/fused_dist.py), as in fused_classic.cu: every
// vector pointer is the rank's first row of an n + 2h array, and a row
// reads the columns [lo, hi) (dia_core.cuh). There the folded scalar is
// computed from the rank's own partial dots; the distributed driver
// reduces the dots over the ranks and forms the scalar itself. The CA
// and pipelined DF launchers take the same bounds and refuse a halo.
//
// Each launcher runs its pass and the finishing stage on `stream` and
// returns cudaGetLastError().
#include "df_core.cuh"

struct K1SrcDF {  // p'(j) = r[j] + beta (p[j] - omega s[j])
  const float* __restrict__ rh;
  const float* __restrict__ rl;
  const float* __restrict__ ph;
  const float* __restrict__ pl;
  const float* __restrict__ sh;
  const float* __restrict__ sl;
  df_t beta, neg_omega;
  __device__ __forceinline__ df_t operator()(long long j) const {
    return df_fma(ld_df(rh, rl, j), beta,
                  df_fma(ld_df(ph, pl, j), neg_omega, ld_df(sh, sl, j)));
  }
};

struct K2SrcDF {  // q(j) = r[j] - alpha s'[j]
  const float* __restrict__ rh;
  const float* __restrict__ rl;
  const float* __restrict__ s2h;
  const float* __restrict__ s2l;
  df_t neg_alpha;
  __device__ __forceinline__ df_t operator()(long long j) const {
    return df_fma(ld_df(rh, rl, j), neg_alpha, ld_df(s2h, s2l, j));
  }
};

struct FoldBeta {  // beta = (alpha / omega) ((r^, r') / rTr)
  const float* alpha_h;
  const float* alpha_l;
  const float* omega_h;
  const float* omega_l;
  const float* rtr_h;
  const float* rtr_l;
  float* out;
  __device__ void operator()(const df_t* d) const {
    st_folded(out, 1, 0,
              df_mul(df_div(ld_scalar(alpha_h, alpha_l),
                            ld_scalar(omega_h, omega_l)),
                     df_div(d[1], ld_scalar(rtr_h, rtr_l))));
  }
};

template <bool kHalo>
__global__ void __launch_bounds__(MBT_BLOCK)
    k1_df_kernel(const __grid_constant__ DiaOffsets offs, long long n,
                 long long lo, long long hi,
                 const float* __restrict__ vh, const float* __restrict__ vl,
                 const float* __restrict__ rh, const float* __restrict__ rl,
                 const float* __restrict__ ph, const float* __restrict__ pl,
                 const float* __restrict__ sh, const float* __restrict__ sl,
                 const float* __restrict__ rhh,
                 const float* __restrict__ rhl,
                 const float* __restrict__ beta_h,
                 const float* __restrict__ beta_l,
                 const float* __restrict__ omega_h,
                 const float* __restrict__ omega_l, float* __restrict__ p2h,
                 float* __restrict__ p2l, float* __restrict__ s2h,
                 float* __restrict__ s2l, float* __restrict__ partials) {
  if (!kHalo) {  // one device: the plain kernel's test, [0, n)
    lo = 0;
    hi = n;
  }
  const K1SrcDF src{rh, rl, ph, pl, sh, sl, ld_scalar(beta_h, beta_l),
                    df_neg(ld_scalar(omega_h, omega_l))};
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  df_t part[1] = {{0.0f, 0.0f}};
  if (i < n) {
    const df_t s2 = dia_row_df(offs, vh, vl, n, i, lo, hi, src);
    st_df(p2h, p2l, i, src(i));
    st_df(s2h, s2l, i, s2);
    part[0] = dot_term(ld_df(rhh, rhl, i), s2);
  }
  store_partials_df<1>(part, partials);
}

template <bool kHalo>
__global__ void __launch_bounds__(MBT_BLOCK)
    k2_df_kernel(const __grid_constant__ DiaOffsets offs, long long n,
                 long long lo, long long hi,
                 const float* __restrict__ vh, const float* __restrict__ vl,
                 const float* __restrict__ rh, const float* __restrict__ rl,
                 const float* __restrict__ s2h,
                 const float* __restrict__ s2l,
                 const float* __restrict__ alpha_h,
                 const float* __restrict__ alpha_l, float* __restrict__ qh,
                 float* __restrict__ ql, float* __restrict__ yh,
                 float* __restrict__ yl, float* __restrict__ partials) {
  if (!kHalo) {  // one device: the plain kernel's test, [0, n)
    lo = 0;
    hi = n;
  }
  const K2SrcDF src{rh, rl, s2h, s2l, df_neg(ld_scalar(alpha_h, alpha_l))};
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  df_t part[2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  if (i < n) {
    const df_t y = dia_row_df(offs, vh, vl, n, i, lo, hi, src);
    const df_t q = src(i);
    st_df(qh, ql, i, q);
    st_df(yh, yl, i, y);
    part[0] = dot_term(q, y);
    part[1] = dot_term(y, y);
  }
  store_partials_df<2>(part, partials);
}

__global__ void __launch_bounds__(MBT_BLOCK)
    k3_df_kernel(long long n, const float* __restrict__ xh,
                 const float* __restrict__ xl,
                 const float* __restrict__ p2h,
                 const float* __restrict__ p2l,
                 const float* __restrict__ qh, const float* __restrict__ ql,
                 const float* __restrict__ yh, const float* __restrict__ yl,
                 const float* __restrict__ rhh,
                 const float* __restrict__ rhl,
                 const float* __restrict__ alpha_h,
                 const float* __restrict__ alpha_l,
                 const float* __restrict__ omega_h,
                 const float* __restrict__ omega_l, float* __restrict__ x2h,
                 float* __restrict__ x2l, float* __restrict__ r2h,
                 float* __restrict__ r2l, float* __restrict__ partials) {
  const df_t a = ld_scalar(alpha_h, alpha_l);
  const df_t w = ld_scalar(omega_h, omega_l);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  df_t part[2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  if (i < n) {
    const df_t q = ld_df(qh, ql, i);
    const df_t r2 = df_fma(q, df_neg(w), ld_df(yh, yl, i));
    st_df(x2h, x2l, i,
          df_fma(df_fma(ld_df(xh, xl, i), a, ld_df(p2h, p2l, i)), w, q));
    st_df(r2h, r2l, i, r2);
    part[0] = dot_term(r2, r2);
    part[1] = dot_term(ld_df(rhh, rhl, i), r2);
  }
  store_partials_df<2>(part, partials);
}

extern "C" {

// partials: [mbt_grid(n), 1, 2] scratch; dots: [2, 1] = (r^, s');
// alpha: [2] = rTr / (r^, s').
cudaError_t mbt_fused_k1_df(const int* offsets, int n_diags, long long n,
                            long long lo, long long hi,
                            const float* vh, const float* vl,
                            const float* rh, const float* rl,
                            const float* ph, const float* pl,
                            const float* sh, const float* sl,
                            const float* rhh, const float* rhl,
                            const float* beta_h, const float* beta_l,
                            const float* omega_h, const float* omega_l,
                            const float* rtr_h, const float* rtr_l,
                            float* p2h, float* p2l, float* s2h, float* s2l,
                            float* partials, float* dots, float* alpha,
                            cudaStream_t stream) {
  DiaOffsets o;
  if (n < 1 || !mbt_bounds_ok(n, lo, hi) ||
      !mbt_fill_offsets(o, offsets, n_diags))
    return cudaErrorInvalidValue;
  const long long G = mbt_grid(n);
  const auto kern =
      mbt_is_halo(n, lo, hi) ? &k1_df_kernel<true> : &k1_df_kernel<false>;
  kern<<<G, MBT_BLOCK, 0, stream>>>(
      o, n, lo, hi, vh, vl, rh, rl, ph, pl, sh, sl, rhh, rhl, beta_h, beta_l,
      omega_h, omega_l, p2h, p2l, s2h, s2l, partials);
  return mbt_finish_df<1>(partials, G, dots,
                          FoldAlpha{rtr_h, rtr_l, alpha}, stream);
}

// partials: [mbt_grid(n), 2, 2] scratch; dots: [2, 2] = (q, y), (y, y);
// omega: [2] = (q, y) / (y, y).
cudaError_t mbt_fused_k2_df(const int* offsets, int n_diags, long long n,
                            long long lo, long long hi,
                            const float* vh, const float* vl,
                            const float* rh, const float* rl,
                            const float* s2h, const float* s2l,
                            const float* alpha_h, const float* alpha_l,
                            float* qh, float* ql, float* yh, float* yl,
                            float* partials, float* dots, float* omega,
                            cudaStream_t stream) {
  DiaOffsets o;
  if (n < 1 || !mbt_bounds_ok(n, lo, hi) ||
      !mbt_fill_offsets(o, offsets, n_diags))
    return cudaErrorInvalidValue;
  const long long G = mbt_grid(n);
  const auto kern =
      mbt_is_halo(n, lo, hi) ? &k2_df_kernel<true> : &k2_df_kernel<false>;
  kern<<<G, MBT_BLOCK, 0, stream>>>(
      o, n, lo, hi, vh, vl, rh, rl, s2h, s2l, alpha_h, alpha_l, qh, ql, yh, yl,
      partials);
  return mbt_finish_df<2>(partials, G, dots, FoldOmega{omega}, stream);
}

// partials: [mbt_grid(n), 2, 2] scratch; dots: [2, 2] = (r', r'),
// (r^, r'); beta: [2] = (alpha / omega) ((r^, r') / rTr).
cudaError_t mbt_fused_k3_df(long long n, const float* xh, const float* xl,
                            const float* p2h, const float* p2l,
                            const float* qh, const float* ql,
                            const float* yh, const float* yl,
                            const float* rhh, const float* rhl,
                            const float* alpha_h, const float* alpha_l,
                            const float* omega_h, const float* omega_l,
                            const float* rtr_h, const float* rtr_l,
                            float* x2h, float* x2l, float* r2h, float* r2l,
                            float* partials, float* dots, float* beta,
                            cudaStream_t stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const long long G = mbt_grid(n);
  k3_df_kernel<<<G, MBT_BLOCK, 0, stream>>>(
      n, xh, xl, p2h, p2l, qh, ql, yh, yl, rhh, rhl, alpha_h, alpha_l,
      omega_h, omega_l, x2h, x2l, r2h, r2l, partials);
  return mbt_finish_df<2>(partials, G, dots,
                          FoldBeta{alpha_h, alpha_l, omega_h, omega_l, rtr_h,
                                   rtr_l, beta},
                          stream);
}

}  // extern "C"
