// The three passes of one fused classic-BiCGStab iteration, float32
// (reference solver.c:86-119 update order, the end-of-loop p update
// deferred into the next iteration's K1):
//
//   K1: p' = r + beta (p - omega s)   recomputed at every neighbour
//       s' = A p'                     partial (r^, s')
//   K2: q  = r - alpha s'             recomputed at every neighbour
//       y  = A q                      partials (q, y), (y, y)
//   K3: x' = x + alpha p' + omega q   pointwise
//       r' = q - omega y              partials (r', r'), (r^, r')
//
// Replaces: mpi_bicgstab_tpu/ops/pallas_fused_classic.py::_k1_kernel,
// ::_k2_kernel and ::_k3_kernel (wrappers fused_k1 / fused_k2 /
// fused_k3). Those DMA a chunk of rows plus the band halo of each source
// vector into VMEM and compute p' or q over the whole window, halo rows
// included. Here each thread owns one row and recomputes the SpMV input
// at each of its W neighbours straight from the source vectors.
//
// Bound on the H100: memory. At n = 1,602,112 and W = 15 the least
// traffic is the band (96.1 MB) plus each vector once: K1 134.6 MB,
// K2 121.8 MB, K3 44.9 MB, floors of 40.2, 36.3 and 13.4 us at
// 3.35 TB/s. The neighbour reads (3 loads per diagonal in K1, 2 in K2)
// are the cost the design accepts: the source vectors (3 x 6.4 MB) fit
// the 50 MB L2, the band streams past them evict-first (dia_core.cuh),
// so the rereads are L2 hits, not HBM traffic.
//
// Hazards handled here (each documented in the JAX code):
// * Out-of-range neighbours are skipped, never read (dia_core.cuh).
// * Aliasing: K1 must not write p' over p or s' over s, nor K2 q over r,
//   since other blocks read those inputs at their halo rows while the
//   kernel runs (pallas_fused_classic.py:226-231). The wrappers allocate
//   separate outputs; K3 is pointwise and would tolerate aliasing.
// * The recomputed p' and q use explicit single-rounding FMAs, so the
//   value a row stores is bit-identical to the value its neighbours
//   recompute for it.
// * Dots: each block writes one partial row of a [G, k] buffer and
//   sum_partials adds them in a fixed order. No float atomics.
// * alpha, beta and omega stay on the device: the kernels read them
//   through pointers to 0-d tensors.
//
// Each launcher runs its pass and the partial-sum stage on `stream` and
// returns cudaGetLastError().
#include "dia_core.cuh"

struct K1Src {  // p'(j) = r[j] + beta (p[j] - omega s[j])
  const float* __restrict__ r;
  const float* __restrict__ p;
  const float* __restrict__ s;
  float beta, omega;
  __device__ __forceinline__ float operator()(long long j) const {
    return __fmaf_rn(beta, __fmaf_rn(-omega, __ldg(s + j), __ldg(p + j)),
                     __ldg(r + j));
  }
};

struct K2Src {  // q(j) = r[j] - alpha s'[j]
  const float* __restrict__ r;
  const float* __restrict__ s2;
  float alpha;
  __device__ __forceinline__ float operator()(long long j) const {
    return __fmaf_rn(-alpha, __ldg(s2 + j), __ldg(r + j));
  }
};

__global__ void __launch_bounds__(MBT_BLOCK)
    k1_kernel(const __grid_constant__ DiaOffsets offs, long long n,
              const float* __restrict__ vals, const float* __restrict__ r,
              const float* __restrict__ p, const float* __restrict__ s,
              const float* __restrict__ r_hat,
              const float* __restrict__ beta,
              const float* __restrict__ omega, float* __restrict__ p2,
              float* __restrict__ s2, float* __restrict__ partials) {
  const K1Src src{r, p, s, *beta, *omega};
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float part[1] = {0.0f};
  if (i < n) {
    const float s2_i = dia_row<float>(offs, vals, n, i, src);
    p2[i] = src(i);
    s2[i] = s2_i;
    part[0] = r_hat[i] * s2_i;
  }
  block_sum<1>(part, partials + blockIdx.x);
}

__global__ void __launch_bounds__(MBT_BLOCK)
    k2_kernel(const __grid_constant__ DiaOffsets offs, long long n,
              const float* __restrict__ vals, const float* __restrict__ r,
              const float* __restrict__ s2,
              const float* __restrict__ alpha, float* __restrict__ q,
              float* __restrict__ y, float* __restrict__ partials) {
  const K2Src src{r, s2, *alpha};
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float part[2] = {0.0f, 0.0f};
  if (i < n) {
    const float y_i = dia_row<float>(offs, vals, n, i, src);
    const float q_i = src(i);
    q[i] = q_i;
    y[i] = y_i;
    part[0] = q_i * y_i;
    part[1] = y_i * y_i;
  }
  block_sum<2>(part, partials + 2 * (long long)blockIdx.x);
}

__global__ void __launch_bounds__(MBT_BLOCK)
    k3_kernel(long long n, const float* __restrict__ x,
              const float* __restrict__ p2, const float* __restrict__ q,
              const float* __restrict__ y, const float* __restrict__ r_hat,
              const float* __restrict__ alpha,
              const float* __restrict__ omega, float* __restrict__ x2,
              float* __restrict__ r2, float* __restrict__ partials) {
  const float a = *alpha, w = *omega;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float part[2] = {0.0f, 0.0f};
  if (i < n) {
    const float q_i = q[i];
    const float r2_i = __fmaf_rn(-w, y[i], q_i);
    x2[i] = __fmaf_rn(w, q_i, __fmaf_rn(a, p2[i], x[i]));
    r2[i] = r2_i;
    part[0] = r2_i * r2_i;
    part[1] = r_hat[i] * r2_i;
  }
  block_sum<2>(part, partials + 2 * (long long)blockIdx.x);
}

extern "C" {

// partials: [mbt_grid(n), 1] scratch; dots: [1] = (r^, s').
cudaError_t mbt_fused_k1_f32(const int* offsets, int n_diags, long long n,
                             const float* vals, const float* r,
                             const float* p, const float* s,
                             const float* r_hat, const float* beta,
                             const float* omega, float* p2, float* s2,
                             float* partials, float* dots,
                             cudaStream_t stream) {
  DiaOffsets o;
  if (n < 1 || !mbt_fill_offsets(o, offsets, n_diags))
    return cudaErrorInvalidValue;
  const long long G = mbt_grid(n);
  k1_kernel<<<G, MBT_BLOCK, 0, stream>>>(o, n, vals, r, p, s, r_hat, beta,
                                         omega, p2, s2, partials);
  return mbt_finish<1>(partials, G, dots, stream);
}

// partials: [mbt_grid(n), 2] scratch; dots: [2] = (q, y), (y, y).
cudaError_t mbt_fused_k2_f32(const int* offsets, int n_diags, long long n,
                             const float* vals, const float* r,
                             const float* s2, const float* alpha, float* q,
                             float* y, float* partials, float* dots,
                             cudaStream_t stream) {
  DiaOffsets o;
  if (n < 1 || !mbt_fill_offsets(o, offsets, n_diags))
    return cudaErrorInvalidValue;
  const long long G = mbt_grid(n);
  k2_kernel<<<G, MBT_BLOCK, 0, stream>>>(o, n, vals, r, s2, alpha, q, y,
                                         partials);
  return mbt_finish<2>(partials, G, dots, stream);
}

// partials: [mbt_grid(n), 2] scratch; dots: [2] = (r', r'), (r^, r').
cudaError_t mbt_fused_k3_f32(long long n, const float* x, const float* p2,
                             const float* q, const float* y,
                             const float* r_hat, const float* alpha,
                             const float* omega, float* x2, float* r2,
                             float* partials, float* dots,
                             cudaStream_t stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const long long G = mbt_grid(n);
  k3_kernel<<<G, MBT_BLOCK, 0, stream>>>(n, x, p2, q, y, r_hat, alpha,
                                         omega, x2, r2, partials);
  return mbt_finish<2>(partials, G, dots, stream);
}

}  // extern "C"
