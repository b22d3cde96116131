// DIA SpMV y = A x, float32, float64 and double-float (DF) pairs.
//
// Replaces: mpi_bicgstab_tpu/ops/pallas_spmv.py::_kernel (wrapper
// _dia_spmv_pallas), the TPU kernel that keeps x resident in VMEM and
// reads an offset o = 128q + s as a row shift plus a lane roll.
//
// Bound on the H100: memory. Per row it moves W band values, one x and
// one y for 2W flops: under half a flop per byte in float32, far below
// the card's ~20 flops per byte (67 TFLOP/s over 3.35 TB/s).
// The least traffic is the band once, x once and y once (108.9 MB at
// n = 1,602,112 in float32: a 32.5 us floor at 3.35 TB/s).
//
// Design: one thread per row, offsets as a __grid_constant__ parameter
// (dia_core.cuh). The W reads of x at i + o are coalesced and, at the
// main path's n, x (6.4 MB) stays in the 50 MB L2 while the band (96 MB)
// streams past it evict-first, so HBM sees about the least traffic
// without any tiling. The launcher returns cudaGetLastError().
//
// The halo form (halo > 0) is the local band multiply of the row-
// partitioned DIA SpMV (parallel/dist_spmv.spmv_dia_halo): x is the rank's
// halo-extended vector of n + 2 halo entries (the neighbours' edge rows,
// or zeros at the ends of the matrix, around the rank's own n), and row i
// reads column j = i + off at x[halo + j] for -halo <= j < n + halo. The
// JAX package forms those slices in XLA (parallel/dist_spmv.py:59-68); at
// halo = 0 the bounds are [0, n) and the kernel is the plain SpMV.
//
// The DF SpMV (mbt_dia_spmv_df) has no Pallas kernel to replace: the JAX
// package computes it in XLA (mpi_bicgstab_tpu/ops/dia.py::dia_spmv_df).
// The port runs it as a kernel on the card for the reason the float64
// SpMV is one: it is the SpMV of every unfused DF solver and of the DF
// classic driver's r0 and true residual. It moves the float64 SpMV's
// bytes (217.9 MB at n = 1,602,112: a 65.0 us floor at 3.35 TB/s) and
// does 18 float operations per band entry (one df_fma), 0.43 GFLOP in
// all: 6.5 us at 67 TFLOP/s, so it too is bound by memory. Its row core,
// dia_row_df (df_core.cuh), is the one the fused DF classic passes use,
// and it takes the plain twin's operation sequence exactly, so kernel and
// twin agree bit for bit.
#include "df_core.cuh"

template <typename T>
struct PlainSrc {
  const T* __restrict__ x;
  __device__ __forceinline__ T operator()(long long j) const {
    return __ldg(x + j);
  }
};

// x points at the rank's first row: x[j] for -halo <= j < n + halo.
template <typename T>
__global__ void __launch_bounds__(MBT_BLOCK)
    dia_spmv_kernel(const __grid_constant__ DiaOffsets offs, long long n,
                    long long halo, const T* __restrict__ vals,
                    const T* __restrict__ x, T* __restrict__ y) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    y[i] = dia_row<T>(offs, vals, n, i, -halo, n + halo, PlainSrc<T>{x});
}

template <typename T>
static cudaError_t launch(const int* offsets, int n_diags, long long n,
                          long long halo, const T* vals, const T* x, T* y,
                          cudaStream_t stream) {
  DiaOffsets o;
  if (n < 1 || halo < 0 || !mbt_fill_offsets(o, offsets, n_diags))
    return cudaErrorInvalidValue;
  dia_spmv_kernel<T><<<mbt_grid(n), MBT_BLOCK, 0, stream>>>(
      o, n, halo, vals, x + halo, y);
  return cudaGetLastError();
}

struct PlainSrcDF {
  const float* __restrict__ xh;
  const float* __restrict__ xl;
  __device__ __forceinline__ df_t operator()(long long j) const {
    return ld_df(xh, xl, j);
  }
};

__global__ void __launch_bounds__(MBT_BLOCK)
    dia_spmv_df_kernel(const __grid_constant__ DiaOffsets offs, long long n,
                       long long halo, const float* __restrict__ vh,
                       const float* __restrict__ vl,
                       const float* __restrict__ xh,
                       const float* __restrict__ xl, float* __restrict__ yh,
                       float* __restrict__ yl) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    st_df(yh, yl, i, dia_row_df(offs, vh, vl, n, i, -halo, n + halo,
                                PlainSrcDF{xh, xl}));
}

extern "C" {

// y [n] = A x, x of n + 2 halo entries (halo 0: the plain SpMV).
cudaError_t mbt_dia_spmv_f32(const int* offsets, int n_diags, long long n,
                             long long halo, const float* vals,
                             const float* x, float* y,
                             cudaStream_t stream) {
  return launch<float>(offsets, n_diags, n, halo, vals, x, y, stream);
}

cudaError_t mbt_dia_spmv_f64(const int* offsets, int n_diags, long long n,
                             long long halo, const double* vals,
                             const double* x, double* y,
                             cudaStream_t stream) {
  return launch<double>(offsets, n_diags, n, halo, vals, x, y, stream);
}

// DF: vals_hi/vals_lo [n_diags, n], x as (hi, lo) arrays of n + 2 halo,
// y as (hi, lo) arrays of n.
cudaError_t mbt_dia_spmv_df(const int* offsets, int n_diags, long long n,
                            long long halo, const float* vals_hi,
                            const float* vals_lo, const float* x_hi,
                            const float* x_lo, float* y_hi, float* y_lo,
                            cudaStream_t stream) {
  DiaOffsets o;
  if (n < 1 || halo < 0 || !mbt_fill_offsets(o, offsets, n_diags))
    return cudaErrorInvalidValue;
  dia_spmv_df_kernel<<<mbt_grid(n), MBT_BLOCK, 0, stream>>>(
      o, n, halo, vals_hi, vals_lo, x_hi + halo, x_lo + halo, y_hi, y_lo);
  return cudaGetLastError();
}

}  // extern "C"
