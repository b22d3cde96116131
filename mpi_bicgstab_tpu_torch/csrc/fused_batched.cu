// The three passes of one fused batched classic-BiCGStab iteration over
// k <= 8 right-hand-side lanes, float32 (the passes of fused_classic.cu,
// lane by lane; reference solver.c:86-119 per lane, the end-of-loop p
// update deferred into the next iteration's K1):
//
//   K1b: p'_l = r_l + beta_l (p_l - omega_l s_l)   recomputed at every
//        s'_l = A p'_l                              neighbour
//        partial (r^_l, s'_l)
//   K2b: q_l  = r_l - alpha_l s'_l                  recomputed at every
//        y_l  = A q_l                               neighbour
//        partials (q_l, y_l), (y_l, y_l)
//   K3b: x'_l = x_l + alpha_l p'_l + omega_l q_l    pointwise
//        r'_l = q_l - omega_l y_l
//        partials (r'_l, r'_l), (r^_l, r'_l)
//
// Replaces: mpi_bicgstab_tpu/ops/pallas_fused_batched.py::_k1_kernel,
// ::_k2_kernel and ::_k3_kernel (wrappers fused_k1b / fused_k2b /
// fused_k3b). Those run on a padded carry with zero halo margins, DMA
// chunk windows of every lane into VMEM and, in K1, write p' and s' over
// p and s in place with a VMEM stash for the rows the next chunk's window
// still needs. None of that is ported: here each thread owns one row of
// every lane (batched_core.cuh), recomputes p' or q at each of its W
// neighbours straight from the source planes, skips out-of-range columns
// and writes fresh outputs. In place would be a race on the card: the
// blocks run concurrently, and a block's neighbours read p and s at its
// rows while it runs.
//
// Frozen lanes (active_l == 0) get their old values written back with a
// select: p' = p and s' = s in K1, x' = x and r' = q in K3 (the JAX kernels
// mask arithmetically, a new + (1 - a) old, which gives the same bits for
// finite values). K2 takes no flag: the solver loop runs frozen lanes with
// alpha = 0, so q = r exactly. The dot partials are those of the
// unmasked values, as in JAX; the solver loop discards a frozen lane's dots.
//
// Bound on the H100: memory. At n = 1,602,112, W = 15, k = 8 one [8, n]
// plane is 51.3 MB and the band 96.1 MB; each input once and each output
// once: K1b 403.7 MB (120.5 us at 3.35 TB/s), K2b 301.2 MB (89.9 us), K3b
// 358.9 MB (107.1 us). The band is read once for all k lanes. The
// neighbour reads (3 k loads per diagonal in K1b, 2 k in K2b) are the
// cost the design accepts, as in fused_classic.cu: they fall on rows
// that the blocks in flight and the band halo share, which stay in L2.
//
// Dots: each block writes one [D, k] row of per-lane partials (lane l's
// d-th partial at d * k + l) and sum_partials adds the rows in a fixed
// order: no float atomics. The per-lane scalars are [k] device arrays
// read through pointers. The recomputed p' and q use explicit
// single-rounding FMAs, so the value a row stores is bit-identical to the
// value its neighbours recompute for it.
//
// Each launcher runs its pass and the partial-sum stage on `stream` and
// returns cudaGetLastError().
#include "batched_core.cuh"

template <int K>
struct K1bSrc {  // p'_l(j) = r_l[j] + beta_l (p_l[j] - omega_l s_l[j])
  const float* __restrict__ r;
  const float* __restrict__ p;
  const float* __restrict__ s;
  long long n;
  float beta[K], omega[K];
  __device__ __forceinline__ float operator()(int l, long long j) const {
    const long long o = (long long)l * n + j;
    return __fmaf_rn(beta[l], __fmaf_rn(-omega[l], __ldg(s + o),
                                        __ldg(p + o)),
                     __ldg(r + o));
  }
};

template <int K>
struct K2bSrc {  // q_l(j) = r_l[j] - alpha_l s'_l[j]
  const float* __restrict__ r;
  const float* __restrict__ s2;
  long long n;
  float alpha[K];
  __device__ __forceinline__ float operator()(int l, long long j) const {
    const long long o = (long long)l * n + j;
    return __fmaf_rn(-alpha[l], __ldg(s2 + o), __ldg(r + o));
  }
};

template <int K>
__global__ void __launch_bounds__(MBT_BLOCK)
    k1b_kernel(const __grid_constant__ DiaOffsets offs, long long n,
               const float* __restrict__ vals, const float* __restrict__ r,
               const float* __restrict__ p, const float* __restrict__ s,
               const float* __restrict__ r_hat,
               const float* __restrict__ beta,
               const float* __restrict__ omega,
               const float* __restrict__ active, float* __restrict__ p2,
               float* __restrict__ s2, float* __restrict__ partials) {
  K1bSrc<K> src;
  src.r = r;
  src.p = p;
  src.s = s;
  src.n = n;
  bool act[K];
#pragma unroll
  for (int l = 0; l < K; ++l) {
    src.beta[l] = beta[l];
    src.omega[l] = omega[l];
    act[l] = active[l] != 0.0f;
  }
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float part[K];
#pragma unroll
  for (int l = 0; l < K; ++l) part[l] = 0.0f;
  if (i < n) {
    float acc[K];
    dia_row_lanes<K>(offs, vals, n, i, src, acc);
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const long long o = (long long)l * n + i;
      p2[o] = act[l] ? src(l, i) : p[o];
      s2[o] = act[l] ? acc[l] : s[o];
      part[l] = r_hat[o] * acc[l];
    }
  }
  block_sum<K>(part, partials + (long long)K * blockIdx.x);
}

template <int K>
__global__ void __launch_bounds__(MBT_BLOCK)
    k2b_kernel(const __grid_constant__ DiaOffsets offs, long long n,
               const float* __restrict__ vals, const float* __restrict__ r,
               const float* __restrict__ s2,
               const float* __restrict__ alpha, float* __restrict__ q,
               float* __restrict__ y, float* __restrict__ partials) {
  K2bSrc<K> src;
  src.r = r;
  src.s2 = s2;
  src.n = n;
#pragma unroll
  for (int l = 0; l < K; ++l) src.alpha[l] = alpha[l];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float part[2 * K];
#pragma unroll
  for (int d = 0; d < 2 * K; ++d) part[d] = 0.0f;
  if (i < n) {
    float acc[K];
    dia_row_lanes<K>(offs, vals, n, i, src, acc);
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const long long o = (long long)l * n + i;
      const float q_i = src(l, i);
      q[o] = q_i;
      y[o] = acc[l];
      part[l] = q_i * acc[l];
      part[K + l] = acc[l] * acc[l];
    }
  }
  block_sum<2 * K>(part, partials + 2LL * K * blockIdx.x);
}

template <int K>
__global__ void __launch_bounds__(MBT_BLOCK)
    k3b_kernel(long long n, const float* __restrict__ x,
               const float* __restrict__ p2, const float* __restrict__ q,
               const float* __restrict__ y, const float* __restrict__ r_hat,
               const float* __restrict__ alpha,
               const float* __restrict__ omega,
               const float* __restrict__ active, float* __restrict__ x2,
               float* __restrict__ r2, float* __restrict__ partials) {
  float a[K], w[K];
  bool act[K];
#pragma unroll
  for (int l = 0; l < K; ++l) {
    a[l] = alpha[l];
    w[l] = omega[l];
    act[l] = active[l] != 0.0f;
  }
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float part[2 * K];
#pragma unroll
  for (int d = 0; d < 2 * K; ++d) part[d] = 0.0f;
  if (i < n) {
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const long long o = (long long)l * n + i;
      const float x_i = x[o];
      const float q_i = q[o];
      const float r2_i = __fmaf_rn(-w[l], y[o], q_i);
      const float x2_i = __fmaf_rn(w[l], q_i, __fmaf_rn(a[l], p2[o], x_i));
      x2[o] = act[l] ? x2_i : x_i;
      r2[o] = act[l] ? r2_i : q_i;
      part[l] = r2_i * r2_i;
      part[K + l] = r_hat[o] * r2_i;
    }
  }
  block_sum<2 * K>(part, partials + 2LL * K * blockIdx.x);
}

template <int K>
static cudaError_t launch_k1b(const DiaOffsets& o, long long n,
                              const float* vals, const float* r,
                              const float* p, const float* s,
                              const float* r_hat, const float* beta,
                              const float* omega, const float* active,
                              float* p2, float* s2, float* partials,
                              float* dots, cudaStream_t stream) {
  const long long G = mbt_grid(n);
  k1b_kernel<K><<<G, MBT_BLOCK, 0, stream>>>(o, n, vals, r, p, s, r_hat,
                                             beta, omega, active, p2, s2,
                                             partials);
  return mbt_finish<K>(partials, G, dots, stream);
}

template <int K>
static cudaError_t launch_k2b(const DiaOffsets& o, long long n,
                              const float* vals, const float* r,
                              const float* s2, const float* alpha, float* q,
                              float* y, float* partials, float* dots,
                              cudaStream_t stream) {
  const long long G = mbt_grid(n);
  k2b_kernel<K><<<G, MBT_BLOCK, 0, stream>>>(o, n, vals, r, s2, alpha, q, y,
                                             partials);
  return mbt_finish<2 * K>(partials, G, dots, stream);
}

template <int K>
static cudaError_t launch_k3b(long long n, const float* x, const float* p2,
                              const float* q, const float* y,
                              const float* r_hat, const float* alpha,
                              const float* omega, const float* active,
                              float* x2, float* r2, float* partials,
                              float* dots, cudaStream_t stream) {
  const long long G = mbt_grid(n);
  k3b_kernel<K><<<G, MBT_BLOCK, 0, stream>>>(n, x, p2, q, y, r_hat, alpha,
                                             omega, active, x2, r2,
                                             partials);
  return mbt_finish<2 * K>(partials, G, dots, stream);
}

extern "C" {

// Planes [k, n]; beta, omega, active [k]; partials [mbt_grid(n), k]
// scratch; dots [k] = (r^_l, s'_l).
cudaError_t mbt_fused_k1b_f32(const int* offsets, int n_diags, long long n,
                              int k, const float* vals, const float* r,
                              const float* p, const float* s,
                              const float* r_hat, const float* beta,
                              const float* omega, const float* active,
                              float* p2, float* s2, float* partials,
                              float* dots, cudaStream_t stream) {
  DiaOffsets o;
  if (n < 1 || !mbt_fill_offsets(o, offsets, n_diags))
    return cudaErrorInvalidValue;
  MBT_BY_LANES(k, launch_k1b<K>(o, n, vals, r, p, s, r_hat, beta, omega,
                                active, p2, s2, partials, dots, stream));
}

// alpha [k]; partials [mbt_grid(n), 2 k] scratch; dots [2, k] = (q_l, y_l),
// (y_l, y_l).
cudaError_t mbt_fused_k2b_f32(const int* offsets, int n_diags, long long n,
                              int k, const float* vals, const float* r,
                              const float* s2, const float* alpha, float* q,
                              float* y, float* partials, float* dots,
                              cudaStream_t stream) {
  DiaOffsets o;
  if (n < 1 || !mbt_fill_offsets(o, offsets, n_diags))
    return cudaErrorInvalidValue;
  MBT_BY_LANES(k, launch_k2b<K>(o, n, vals, r, s2, alpha, q, y, partials,
                                dots, stream));
}

// alpha, omega, active [k]; partials [mbt_grid(n), 2 k] scratch; dots
// [2, k] = (r'_l, r'_l), (r^_l, r'_l).
cudaError_t mbt_fused_k3b_f32(long long n, int k, const float* x,
                              const float* p2, const float* q,
                              const float* y, const float* r_hat,
                              const float* alpha, const float* omega,
                              const float* active, float* x2, float* r2,
                              float* partials, float* dots,
                              cudaStream_t stream) {
  if (n < 1) return cudaErrorInvalidValue;
  MBT_BY_LANES(k, launch_k3b<K>(n, x, p2, q, y, r_hat, alpha, omega, active,
                                x2, r2, partials, dots, stream));
}

}  // extern "C"
