// The two phases of one fused pipelined-BiCGStab iteration, float32
// (reference solver.c:351-388). The SpMV input of each phase is formed
// before it (z' = t + beta (z - omega v) and w' = y - omega (t - alpha
// v'), plain tensor operations, where the JAX driver forms them in XLA):
//
//   phase A: v' = A z'
//            p' = r + beta (p - omega s)
//            s' = w + beta (s - omega z)   z is the OLD z, not z'
//            q  = r - alpha s',  y = w - alpha z'
//                                          partials (q, y), (y, y)
//   phase B: t' = A w'
//            x' = x + alpha p' + omega q
//            r' = q - omega y              partials (r', r'), (r^, r'),
//                                          (r^, w'), (r^, s'), (r^, z')
//
// Replaces: mpi_bicgstab_tpu/ops/pallas_fused_pipe.py::_phase_a_kernel
// and ::_phase_b_kernel (wrappers fused_phase_a / fused_phase_b). Those
// keep the whole SpMV input resident in VMEM and stream (8,128) tiles of
// the other vectors past it. Here the SpMV input arrives whole in device
// memory, each thread owns one row and reads its W neighbours directly:
// unlike CA and classic, no neighbour value has to be recomputed.
//
// Bound on the H100: memory. At n = 1,602,112 and W = 15 the least
// traffic is the band (96.1 MB) plus each vector once: phase A reads 6
// and writes 5, phase B reads 8 and writes 3, 166.6 MB each, a 49.7 us
// floor at 3.35 TB/s. The W reads of the SpMV input per row are
// coalesced and hit L2 (6.4 MB of input, the band evict-first).
//
// Hazards handled here:
// * Out-of-range neighbours are skipped, never read (dia_core.cuh).
// * Phase A's s' reads the old z (pallas_fused_pipe.py:148-151): the
//   old z is its own argument, separate from the SpMV input z'.
// * Aliasing: no output may alias z' or w', which other blocks read at
//   their neighbour rows; the wrappers allocate fresh outputs.
// * Dots: one partial row per block, summed in a fixed order by
//   sum_partials. No float atomics.
// * alpha, beta and omega stay on the device, read through pointers.
//
// The halo form (solvers/fused_dist.py; the JAX package's
// solvers/fused_dist.py puts the neighbours' rows in the Pallas kernels'
// zero margins): in a row-partitioned solve every vector holds the rank's
// n rows with h entries of each neighbour's edge rows before and after,
// exchanged before the pass. The wrappers pass pointers to the rank's
// first row, and the launchers take the columns [lo, hi) a row may read
// (dia_core.cuh); [0, n) on one device. Only the SpMV input (z'
// or w') is read at a neighbour's rows.
#include "dia_core.cuh"

struct WholeSrc {  // the SpMV input, read as it is
  const float* __restrict__ x;
  __device__ __forceinline__ float operator()(long long j) const {
    return __ldg(x + j);
  }
};

template <bool kHalo>
__global__ void __launch_bounds__(MBT_BLOCK)
    phase_a_kernel(const __grid_constant__ DiaOffsets offs, long long n,
                   long long lo, long long hi,
                   const float* __restrict__ vals,
                   const float* __restrict__ z_new,
                   const float* __restrict__ r, const float* __restrict__ p,
                   const float* __restrict__ s, const float* __restrict__ w,
                   const float* __restrict__ z_old,
                   const float* __restrict__ alpha,
                   const float* __restrict__ beta,
                   const float* __restrict__ omega, float* __restrict__ v2,
                   float* __restrict__ p2, float* __restrict__ s2,
                   float* __restrict__ q, float* __restrict__ y,
                   float* __restrict__ partials) {
  if (!kHalo) {  // one device: the plain kernel's test, [0, n)
    lo = 0;
    hi = n;
  }
  const float a = *alpha, b = *beta, om = *omega;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float part[2] = {0.0f, 0.0f};
  if (i < n) {
    v2[i] = dia_row<float>(offs, vals, n, i, lo, hi, WholeSrc{z_new});
    const float r_i = r[i], s_i = s[i], w_i = w[i];
    const float s2_i = __fmaf_rn(b, __fmaf_rn(-om, z_old[i], s_i), w_i);
    const float q_i = __fmaf_rn(-a, s2_i, r_i);
    const float y_i = __fmaf_rn(-a, z_new[i], w_i);
    p2[i] = __fmaf_rn(b, __fmaf_rn(-om, s_i, p[i]), r_i);
    s2[i] = s2_i;
    q[i] = q_i;
    y[i] = y_i;
    part[0] = q_i * y_i;
    part[1] = y_i * y_i;
  }
  block_sum<2>(part, partials + 2 * (long long)blockIdx.x);
}

template <bool kHalo>
__global__ void __launch_bounds__(MBT_BLOCK)
    phase_b_kernel(const __grid_constant__ DiaOffsets offs, long long n,
                   long long lo, long long hi,
                   const float* __restrict__ vals,
                   const float* __restrict__ w_new,
                   const float* __restrict__ x,
                   const float* __restrict__ p2,
                   const float* __restrict__ q, const float* __restrict__ y,
                   const float* __restrict__ r_hat,
                   const float* __restrict__ s2,
                   const float* __restrict__ z2,
                   const float* __restrict__ alpha,
                   const float* __restrict__ omega, float* __restrict__ t2,
                   float* __restrict__ x2, float* __restrict__ r2,
                   float* __restrict__ partials) {
  if (!kHalo) {  // one device: the plain kernel's test, [0, n)
    lo = 0;
    hi = n;
  }
  const float a = *alpha, om = *omega;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float part[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (i < n) {
    t2[i] = dia_row<float>(offs, vals, n, i, lo, hi, WholeSrc{w_new});
    const float q_i = q[i], rh = r_hat[i];
    const float r2_i = __fmaf_rn(-om, y[i], q_i);
    x2[i] = __fmaf_rn(om, q_i, __fmaf_rn(a, p2[i], x[i]));
    r2[i] = r2_i;
    part[0] = r2_i * r2_i;
    part[1] = rh * r2_i;
    part[2] = rh * w_new[i];
    part[3] = rh * s2[i];
    part[4] = rh * z2[i];
  }
  block_sum<5>(part, partials + 5 * (long long)blockIdx.x);
}

extern "C" {

// scalars: 0-d device floats. partials: [mbt_grid(n), 2] scratch;
// dots: [2] = (q, y), (y, y).
cudaError_t mbt_phase_a_f32(const int* offsets, int n_diags, long long n,
                            long long lo, long long hi,
                            const float* vals, const float* z_new,
                            const float* r, const float* p, const float* s,
                            const float* w, const float* z_old,
                            const float* alpha, const float* beta,
                            const float* omega, float* v2, float* p2,
                            float* s2, float* q, float* y, float* partials,
                            float* dots, cudaStream_t stream) {
  DiaOffsets o;
  if (n < 1 || !mbt_bounds_ok(n, lo, hi) ||
      !mbt_fill_offsets(o, offsets, n_diags))
    return cudaErrorInvalidValue;
  const long long G = mbt_grid(n);
  const auto kern =
      mbt_is_halo(n, lo, hi) ? &phase_a_kernel<true> : &phase_a_kernel<false>;
  kern<<<G, MBT_BLOCK, 0, stream>>>(
      o, n, lo, hi, vals, z_new, r, p, s, w, z_old, alpha, beta, omega, v2, p2,
      s2, q, y, partials);
  return mbt_finish<2>(partials, G, dots, stream);
}

// partials: [mbt_grid(n), 5] scratch; dots: [5] = (r', r'), (r^, r'),
// (r^, w'), (r^, s'), (r^, z').
cudaError_t mbt_phase_b_f32(const int* offsets, int n_diags, long long n,
                            long long lo, long long hi,
                            const float* vals, const float* w_new,
                            const float* x, const float* p2, const float* q,
                            const float* y, const float* r_hat,
                            const float* s2, const float* z2,
                            const float* alpha, const float* omega,
                            float* t2, float* x2, float* r2, float* partials,
                            float* dots, cudaStream_t stream) {
  DiaOffsets o;
  if (n < 1 || !mbt_bounds_ok(n, lo, hi) ||
      !mbt_fill_offsets(o, offsets, n_diags))
    return cudaErrorInvalidValue;
  const long long G = mbt_grid(n);
  const auto kern =
      mbt_is_halo(n, lo, hi) ? &phase_b_kernel<true> : &phase_b_kernel<false>;
  kern<<<G, MBT_BLOCK, 0, stream>>>(
      o, n, lo, hi, vals, w_new, x, p2, q, y, r_hat, s2, z2, alpha, omega, t2,
      x2, r2, partials);
  return mbt_finish<5>(partials, G, dots, stream);
}

}  // extern "C"
