// Batched DIA SpMV Y[l] = A X[l] for k <= 8 right-hand-side lanes, float32.
// X and Y are [k, n] row-major; in the halo form (the row-partitioned
// batch, solvers/batched_dist.py) X is [k, n + 2h], lane stride ldx, its
// pointer at the rank's first row, the columns [lo, hi) read, and Y the
// rank's [k, n].
//
// Replaces: mpi_bicgstab_tpu/ops/pallas_batched_spmv.py::_kernel (wrapper
// batched_dia_spmv). That kernel double-buffers one [W, 64, 128] block of
// band values per grid step in VMEM and applies it to all k lanes'
// windows, DMA'd chunk by chunk into VMEM scratch. Here one thread owns one
// row of every lane (batched_core.cuh): it reads each band value once and
// applies it to the k accumulators it holds in registers. There is no
// window, no chunking and no padding to the 8192-row grid: out-of-range
// columns are skipped.
//
// Bound on the H100: memory. The least traffic is the band once, X once
// and Y once: at n = 1,602,112, W = 15, k = 8 that is 96.1 + 51.3 + 51.3
// = 198.7 MB, a 59.3 us floor at 3.35 TB/s; the 2 W k flops per row are
// 0.38 GFLOP, 5.7 us at 67 TFLOP/s. The k lanes' rereads at the W
// neighbours of a row are L2 hits: the rows the blocks in flight touch,
// plus the band halo (+-13,807 rows at that shape), are ~10 MB of X, and
// the band streams past them evict-first (dia_core.cuh).
//
// The launcher returns cudaGetLastError().
#include "batched_core.cuh"

struct LaneSrc {  // X[l, j]
  const float* __restrict__ x;
  long long ld;
  __device__ __forceinline__ float operator()(int l, long long j) const {
    return __ldg(x + (long long)l * ld + j);
  }
};

template <int K, bool kHalo>
__global__ void __launch_bounds__(MBT_BLOCK)
    batched_spmv_kernel(const __grid_constant__ DiaOffsets offs, long long n,
                        long long lo, long long hi, long long ldx,
                        const float* __restrict__ vals,
                        const float* __restrict__ x, float* __restrict__ y) {
  if (!kHalo) {  // one device: the plain kernel's bounds and stride
    lo = 0;
    hi = n;
    ldx = n;
  }
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc[K];
  dia_row_lanes<K>(offs, vals, n, i, lo, hi, LaneSrc{x, ldx}, acc);
#pragma unroll
  for (int l = 0; l < K; ++l) y[(long long)l * n + i] = acc[l];
}

template <int K, bool kHalo>
static cudaError_t launch(const DiaOffsets& o, long long n, long long lo,
                          long long hi, long long ldx, const float* vals,
                          const float* x, float* y, cudaStream_t stream) {
  batched_spmv_kernel<K, kHalo><<<mbt_grid(n), MBT_BLOCK, 0, stream>>>(
      o, n, lo, hi, ldx, vals, x, y);
  return cudaGetLastError();
}

extern "C" {

// vals [n_diags, n]; x [k, ldx] from its rank's first row, columns
// [lo, hi) read (0, n, n on one device); y [k, n].
cudaError_t mbt_batched_dia_spmv_f32(const int* offsets, int n_diags,
                                     long long n, long long lo, long long hi,
                                     long long ldx, int k, const float* vals,
                                     const float* x, float* y,
                                     cudaStream_t stream) {
  DiaOffsets o;
  if (n < 1 || !mbt_lanes_ok(n, lo, hi, ldx) ||
      !mbt_fill_offsets(o, offsets, n_diags))
    return cudaErrorInvalidValue;
  MBT_BY_LANES_HALO(k, mbt_lanes_halo(n, lo, hi, ldx),
                    (launch<K, kHalo>(o, n, lo, hi, ldx, vals, x, y,
                                      stream)));
}

}  // extern "C"
