// DIA SpMV y = A x, float32 and float64.
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
#include "dia_core.cuh"

template <typename T>
struct PlainSrc {
  const T* __restrict__ x;
  __device__ __forceinline__ T operator()(long long j) const {
    return __ldg(x + j);
  }
};

template <typename T>
__global__ void __launch_bounds__(MBT_BLOCK)
    dia_spmv_kernel(const __grid_constant__ DiaOffsets offs, long long n,
                    const T* __restrict__ vals, const T* __restrict__ x,
                    T* __restrict__ y) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = dia_row<T>(offs, vals, n, i, PlainSrc<T>{x});
}

template <typename T>
static cudaError_t launch(const int* offsets, int n_diags, long long n,
                          const T* vals, const T* x, T* y,
                          cudaStream_t stream) {
  DiaOffsets o;
  if (n < 1 || !mbt_fill_offsets(o, offsets, n_diags))
    return cudaErrorInvalidValue;
  dia_spmv_kernel<T><<<mbt_grid(n), MBT_BLOCK, 0, stream>>>(o, n, vals, x,
                                                            y);
  return cudaGetLastError();
}

extern "C" {

cudaError_t mbt_dia_spmv_f32(const int* offsets, int n_diags, long long n,
                             const float* vals, const float* x, float* y,
                             cudaStream_t stream) {
  return launch<float>(offsets, n_diags, n, vals, x, y, stream);
}

cudaError_t mbt_dia_spmv_f64(const int* offsets, int n_diags, long long n,
                             const double* vals, const double* x,
                             double* y, cudaStream_t stream) {
  return launch<double>(offsets, n_diags, n, vals, x, y, stream);
}

}  // extern "C"
