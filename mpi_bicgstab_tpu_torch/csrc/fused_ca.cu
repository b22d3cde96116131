// The two passes of one fused CA-BiCGStab iteration, float32 (reference
// solver.c:216-249, communication-avoiding rearrangement):
//
//   K1: p' = r + beta (p - omega s)   pointwise
//       s' = w + beta (s - omega z)   recomputed at every neighbour
//       z' = A s'
//       q  = r - alpha s',  y = w - alpha z'
//                                     partials (q, y), (y, y)
//   K2: r' = q - omega y              recomputed at every neighbour
//       w' = A r'
//       x' = x + alpha p' + omega q   pointwise
//                                     partials (r', r'), (r^, r'),
//                                     (r^, w'), (r^, s'), (r^, z')
//
// Replaces: mpi_bicgstab_tpu/ops/pallas_fused_ca.py::_k1_kernel and
// ::_k2_kernel (wrappers fused_ca_k1 / fused_ca_k2). Those DMA a chunk of
// rows plus the band halo of each source vector into VMEM and form s'
// (or r') over the whole window. Here each thread owns one row and
// recomputes the SpMV input at each of its W neighbours straight from
// the source vectors, as K1 and K2 of fused_classic.cu do.
//
// Bound on the H100: memory. At n = 1,602,112 and W = 15 the least
// traffic is the band (96.1 MB) plus each vector once: K1 reads 5 and
// writes 5, K2 reads 7 and writes 3, 160.2 MB each, a 47.8 us floor at
// 3.35 TB/s. The neighbour reads (3 loads per diagonal in K1, 2 in K2)
// hit L2: the source vectors fit the 50 MB L2 while the band streams
// past them evict-first (dia_core.cuh).
//
// Hazards handled here (each documented in the JAX code):
// * Out-of-range neighbours are skipped, never read (dia_core.cuh).
// * Aliasing: other blocks read K1's s, w, z and K2's q, y at their halo
//   rows while the kernel runs (pallas_fused_classic.py:226-231), so no
//   output may alias an input; the wrappers allocate fresh outputs.
// * The recomputed s' and r' use explicit single-rounding FMAs, so the
//   value a row stores is bit-identical to the value its neighbours
//   recompute for it.
// * Dots: one partial row per block of a [G, k] buffer, summed in a
//   fixed order by sum_partials. No float atomics.
// * alpha, beta and omega stay on the device, read through pointers.
#include "dia_core.cuh"

struct CaK1Src {  // s'(j) = w[j] + beta (s[j] - omega z[j])
  const float* __restrict__ w;
  const float* __restrict__ s;
  const float* __restrict__ z;
  float beta, omega;
  __device__ __forceinline__ float operator()(long long j) const {
    return __fmaf_rn(beta, __fmaf_rn(-omega, __ldg(z + j), __ldg(s + j)),
                     __ldg(w + j));
  }
};

struct CaK2Src {  // r'(j) = q[j] - omega y[j]
  const float* __restrict__ q;
  const float* __restrict__ y;
  float omega;
  __device__ __forceinline__ float operator()(long long j) const {
    return __fmaf_rn(-omega, __ldg(y + j), __ldg(q + j));
  }
};

__global__ void __launch_bounds__(MBT_BLOCK)
    ca_k1_kernel(const __grid_constant__ DiaOffsets offs, long long n,
                 const float* __restrict__ vals, const float* __restrict__ r,
                 const float* __restrict__ p, const float* __restrict__ s,
                 const float* __restrict__ w, const float* __restrict__ z,
                 const float* __restrict__ alpha,
                 const float* __restrict__ beta,
                 const float* __restrict__ omega, float* __restrict__ p2,
                 float* __restrict__ s2, float* __restrict__ z2,
                 float* __restrict__ q, float* __restrict__ y,
                 float* __restrict__ partials) {
  const float a = *alpha, b = *beta, om = *omega;
  const CaK1Src src{w, s, z, b, om};
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float part[2] = {0.0f, 0.0f};
  if (i < n) {
    const float z2_i = dia_row<float>(offs, vals, n, i, src);
    const float s2_i = src(i);
    const float r_i = r[i];
    const float q_i = __fmaf_rn(-a, s2_i, r_i);
    const float y_i = __fmaf_rn(-a, z2_i, w[i]);
    p2[i] = __fmaf_rn(b, __fmaf_rn(-om, s[i], p[i]), r_i);
    s2[i] = s2_i;
    z2[i] = z2_i;
    q[i] = q_i;
    y[i] = y_i;
    part[0] = q_i * y_i;
    part[1] = y_i * y_i;
  }
  block_sum<2>(part, partials + 2 * (long long)blockIdx.x);
}

__global__ void __launch_bounds__(MBT_BLOCK)
    ca_k2_kernel(const __grid_constant__ DiaOffsets offs, long long n,
                 const float* __restrict__ vals, const float* __restrict__ q,
                 const float* __restrict__ y, const float* __restrict__ x,
                 const float* __restrict__ p2,
                 const float* __restrict__ r_hat,
                 const float* __restrict__ s2, const float* __restrict__ z2,
                 const float* __restrict__ alpha,
                 const float* __restrict__ omega, float* __restrict__ x2,
                 float* __restrict__ r2, float* __restrict__ w2,
                 float* __restrict__ partials) {
  const float a = *alpha, om = *omega;
  const CaK2Src src{q, y, om};
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float part[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (i < n) {
    const float w2_i = dia_row<float>(offs, vals, n, i, src);
    const float r2_i = src(i);
    const float rh = r_hat[i];
    x2[i] = __fmaf_rn(om, q[i], __fmaf_rn(a, p2[i], x[i]));
    r2[i] = r2_i;
    w2[i] = w2_i;
    part[0] = r2_i * r2_i;
    part[1] = rh * r2_i;
    part[2] = rh * w2_i;
    part[3] = rh * s2[i];
    part[4] = rh * z2[i];
  }
  block_sum<5>(part, partials + 5 * (long long)blockIdx.x);
}

extern "C" {

// scalars: 0-d device floats. partials: [mbt_grid(n), 2] scratch;
// dots: [2] = (q, y), (y, y).
cudaError_t mbt_ca_k1_f32(const int* offsets, int n_diags, long long n,
                          const float* vals, const float* r, const float* p,
                          const float* s, const float* w, const float* z,
                          const float* alpha, const float* beta,
                          const float* omega, float* p2, float* s2,
                          float* z2, float* q, float* y, float* partials,
                          float* dots, cudaStream_t stream) {
  DiaOffsets o;
  if (n < 1 || !mbt_fill_offsets(o, offsets, n_diags))
    return cudaErrorInvalidValue;
  const long long G = mbt_grid(n);
  ca_k1_kernel<<<G, MBT_BLOCK, 0, stream>>>(o, n, vals, r, p, s, w, z,
                                            alpha, beta, omega, p2, s2, z2,
                                            q, y, partials);
  return mbt_finish<2>(partials, G, dots, stream);
}

// partials: [mbt_grid(n), 5] scratch; dots: [5] = (r', r'), (r^, r'),
// (r^, w'), (r^, s'), (r^, z').
cudaError_t mbt_ca_k2_f32(const int* offsets, int n_diags, long long n,
                          const float* vals, const float* q, const float* y,
                          const float* x, const float* p2,
                          const float* r_hat, const float* s2,
                          const float* z2, const float* alpha,
                          const float* omega, float* x2, float* r2,
                          float* w2, float* partials, float* dots,
                          cudaStream_t stream) {
  DiaOffsets o;
  if (n < 1 || !mbt_fill_offsets(o, offsets, n_diags))
    return cudaErrorInvalidValue;
  const long long G = mbt_grid(n);
  ca_k2_kernel<<<G, MBT_BLOCK, 0, stream>>>(o, n, vals, q, y, x, p2, r_hat,
                                            s2, z2, alpha, omega, x2, r2,
                                            w2, partials);
  return mbt_finish<5>(partials, G, dots, stream);
}

}  // extern "C"
