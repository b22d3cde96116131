// The whole degree-d Chebyshev application x = p(A) v over a DIA band, in
// float32 and in double-float (DF) arithmetic, as ONE cooperative launch:
//
//   x_0 = v / theta;  r_0 = v - A x_0;  d_0 = r_0 / theta
//   for k = 0 .. d-1:  x_{k+1} = x_k + d_k
//                      r_{k+1} = r_k - A d_k
//                      d_{k+1} = c_d^k d_k + c_r^k r_{k+1}
//
// (ops/cheby.py: _coeffs, cheby_apply), in the JAX package's expression
// order. x_d is the result; it needs d_{d-1} but never r_d or d_d, so the
// last step's SpMV is skipped and the band is read d times, not d + 1.
//
// Replaces: mpi_bicgstab_tpu/ops/pallas_cheby.py::_cheby_kernel (wrapper
// cheby_chain) and mpi_bicgstab_tpu/ops/pallas_cheby_df.py::
// _cheby_kernel_df (cheby_chain_df). Those DMA a (chunk + d halo)-row
// window of v and of the band into VMEM once per chunk and run the whole
// chain on it, recomputing the halo rows. On transport_hard(1602112) at
// d = 8 the halo is 8 x 27,378 rows on each side: a window that size fits
// no block's shared memory, and its redundant rows would cost more than
// the reads they save. Here the grid is persistent (as many blocks as fit
// on the card at once, from the occupancy query), walks the rows in
// grid-stride loops, and a grid-wide barrier (cooperative_groups
// this_grid().sync()) separates the steps, so every SpMV reads a complete
// d_k. d is ping-ponged between two buffers, since other rows read the old
// d at their band columns while a step writes the new one; x and r are
// row-local and updated in place. v, x, r and the two d buffers are
// wrapper-allocated and, at the main path's n, mostly stay in the 50 MB L2
// (5 x 6.4 MB in float32).
//
// Bound on the H100: memory. The least traffic for the function is the
// band once, v in and x out: 60 B/row in float32 at W = 13, 96.1 MB at
// n = 1,601,613 (0.0287 ms at 3.35 TB/s), twice that in DF. This design
// reads the band d times (416 B/row at d = 8 in float32, 0.199 ms), which
// is the floor it can reach; the arithmetic (2 flops per band entry and
// step in float32, one 18-flop df_fma in DF) is under a tenth of that.
//
// Exactness: every float32 operation is __fadd_rn / __fsub_rn / __fmul_rn,
// never contracted, in the twin's order (dia_spmv_plain accumulates
// acc + vals[w] x from zero, diagonal by diagonal), so the float32 chain
// takes the plain twin's roundings; the DF chain uses df_core.cuh in the
// twin's nesting and equals it bit for bit. The coefficients are computed
// on the host in float64, rounded to float32 (DF: split into hi, lo) and
// travel by value in the kernel's parameter block: no device copy, so a
// preconditioned tol=0 solve captures in a CUDA graph.
#include <cooperative_groups.h>

#include "df_core.cuh"

namespace cg = cooperative_groups;

#define MBT_MAX_CHEBY_DEGREE 64

struct ChebyCoeffs {
  int degree;
  float inv_theta;
  float cd[MBT_MAX_CHEBY_DEGREE];
  float cr[MBT_MAX_CHEBY_DEGREE];
};

struct ChebyCoeffsDF {
  int degree;
  df_t inv_theta;
  df_t cd[MBT_MAX_CHEBY_DEGREE];
  df_t cr[MBT_MAX_CHEBY_DEGREE];
};

// sum_w vals[w, i] * src(i + off[w]) over the in-range columns, each
// product and sum rounded on its own (the twin's pad-plus-slice order).
template <typename Src>
__device__ __forceinline__ float dia_row_rn(const DiaOffsets& offs,
                                            const float* __restrict__ vals,
                                            long long n, long long i,
                                            Src src) {
  float acc = 0.0f;
  for (int w = 0; w < offs.n_diags; ++w) {
    const long long j = i + offs.off[w];
    const float a = __ldcs(vals + (long long)w * n + i);
    if (j >= 0 && j < n) acc = __fadd_rn(acc, __fmul_rn(a, src(j)));
  }
  return acc;
}

struct ScaledSrc {  // x_0 = v / theta, formed at the band columns
  const float* __restrict__ v;
  float s;
  __device__ __forceinline__ float operator()(long long j) const {
    return __fmul_rn(s, v[j]);
  }
};

// A vector this launch also writes (in another step): plain loads, never
// __ldg or const __restrict__, whose non-coherent cache could serve a value
// from before the last grid barrier.
struct VecSrc {
  const float* d;
  __device__ __forceinline__ float operator()(long long j) const {
    return d[j];
  }
};

struct VecSrcDF {
  const float* h;
  const float* l;
  __device__ __forceinline__ df_t operator()(long long j) const {
    return {h[j], l[j]};
  }
};

__global__ void __launch_bounds__(MBT_BLOCK)
    cheby_f32_kernel(const __grid_constant__ DiaOffsets offs,
                     const __grid_constant__ ChebyCoeffs c, long long n,
                     const float* __restrict__ vals,
                     const float* __restrict__ v, float* x, float* r,
                     float* d0, float* d1) {
  cg::grid_group grid = cg::this_grid();
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float it = c.inv_theta;
  for (long long i = first; i < n; i += stride) {
    const float vi = v[i];
    const float ri = __fsub_rn(vi, dia_row_rn(offs, vals, n, i,
                                              ScaledSrc{v, it}));
    const float di = __fmul_rn(it, ri);
    const float xi = __fmul_rn(it, vi);
    if (c.degree == 1) {
      x[i] = __fadd_rn(xi, di);
    } else {
      x[i] = xi;
      r[i] = ri;
      d0[i] = di;
    }
  }
  // step k reads d_k at the band columns and writes d_{k+1}; its last
  // call (k = d - 2) also adds d_{k+1} to x, which is then x_d
  float* dc = d0;
  float* dn = d1;
  for (int k = 0; k + 1 < c.degree; ++k) {
    grid.sync();
    const float cd = c.cd[k];
    const float cr = c.cr[k];
    const bool last = k + 2 == c.degree;
    for (long long i = first; i < n; i += stride) {
      const float di = dc[i];
      const float xi = __fadd_rn(x[i], di);
      const float rn = __fsub_rn(r[i], dia_row_rn(offs, vals, n, i,
                                                  VecSrc{dc}));
      const float dni = __fadd_rn(__fmul_rn(cd, di), __fmul_rn(cr, rn));
      if (last) {
        x[i] = __fadd_rn(xi, dni);
      } else {
        x[i] = xi;
        r[i] = rn;
        dn[i] = dni;
      }
    }
    float* t = dc;
    dc = dn;
    dn = t;
  }
}

// --- double-float --------------------------------------------------------

struct ScaledSrcDF {  // x_0 = 0 + (1 / theta) v, formed at the band columns
  const float* __restrict__ vh;
  const float* __restrict__ vl;
  df_t s;
  __device__ __forceinline__ df_t operator()(long long j) const {
    return df_fma({0.0f, 0.0f}, s, ld_df(vh, vl, j));
  }
};

__global__ void __launch_bounds__(MBT_BLOCK)
    cheby_df_kernel(const __grid_constant__ DiaOffsets offs,
                    const __grid_constant__ ChebyCoeffsDF c, long long n,
                    const float* __restrict__ valh,
                    const float* __restrict__ vall,
                    const float* __restrict__ vh,
                    const float* __restrict__ vl, float* xh, float* xl,
                    float* scratch) {
  cg::grid_group grid = cg::this_grid();
  // scratch: [6, n] = r (hi, lo), d0 (hi, lo), d1 (hi, lo)
  float* rh = scratch;
  float* rl = scratch + n;
  float* dch = scratch + 2 * n;
  float* dcl = scratch + 3 * n;
  float* dnh = scratch + 4 * n;
  float* dnl = scratch + 5 * n;
  const df_t zero = {0.0f, 0.0f};
  const df_t one = {1.0f, 0.0f};
  const df_t minus_one = {-1.0f, 0.0f};
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const df_t it = c.inv_theta;
  for (long long i = first; i < n; i += stride) {
    const df_t vi = ld_df(vh, vl, i);
    const df_t ax =
        dia_row_df(offs, valh, vall, n, i, ScaledSrcDF{vh, vl, it});
    const df_t ri = df_fma(vi, minus_one, ax);
    const df_t di = df_fma(zero, it, ri);
    const df_t xi = df_fma(zero, it, vi);
    if (c.degree == 1) {
      st_df(xh, xl, i, df_fma(xi, one, di));
    } else {
      st_df(xh, xl, i, xi);
      st_df(rh, rl, i, ri);
      st_df(dch, dcl, i, di);
    }
  }
  for (int k = 0; k + 1 < c.degree; ++k) {
    grid.sync();
    const df_t cd = c.cd[k];
    const df_t cr = c.cr[k];
    const bool last = k + 2 == c.degree;
    for (long long i = first; i < n; i += stride) {
      const df_t di = {dch[i], dcl[i]};
      const df_t xi = df_fma({xh[i], xl[i]}, one, di);
      const df_t y = dia_row_df(offs, valh, vall, n, i,
                                VecSrcDF{dch, dcl});
      const df_t rn = df_fma({rh[i], rl[i]}, minus_one, y);
      const df_t dni = df_fma(df_fma(zero, cd, di), cr, rn);
      if (last) {
        st_df(xh, xl, i, df_fma(xi, one, dni));
      } else {
        st_df(xh, xl, i, xi);
        st_df(rh, rl, i, rn);
        st_df(dnh, dnl, i, dni);
      }
    }
    float* t = dch;
    dch = dnh;
    dnh = t;
    t = dcl;
    dcl = dnl;
    dnl = t;
  }
}

// The persistent grid: every block resident at once (a cooperative launch
// refuses more), and no more blocks than rows need.
template <typename Kernel>
static cudaError_t coop_grid(Kernel kernel, long long n, int* grid) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      MBT_BLOCK, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  const long long need = mbt_grid(n);
  const long long have = (long long)per_sm * sms;
  *grid = (int)(need < have ? need : have);
  return cudaSuccess;
}

extern "C" {

// coeffs (host): inv_theta, then (c_d, c_r) per step; scratch: [3, n] =
// r, d0, d1 (float32); x: the [n] result.
cudaError_t mbt_cheby_chain_f32(const int* offsets, int n_diags, long long n,
                                const float* vals, const float* v,
                                const float* coeffs, int degree, float* x,
                                float* scratch, cudaStream_t stream) {
  DiaOffsets o;
  if (n < 1 || degree < 1 || degree > MBT_MAX_CHEBY_DEGREE ||
      !mbt_fill_offsets(o, offsets, n_diags))
    return cudaErrorInvalidValue;
  ChebyCoeffs c;
  c.degree = degree;
  c.inv_theta = coeffs[0];
  for (int k = 0; k < degree; ++k) {
    c.cd[k] = coeffs[1 + 2 * k];
    c.cr[k] = coeffs[2 + 2 * k];
  }
  int grid = 0;
  cudaError_t err = coop_grid(cheby_f32_kernel, n, &grid);
  if (err != cudaSuccess) return err;
  float* r = scratch;
  float* d0 = scratch + n;
  float* d1 = scratch + 2 * n;
  void* args[] = {&o, &c, &n, &vals, &v, &x, &r, &d0, &d1};
  err = cudaLaunchCooperativeKernel((const void*)cheby_f32_kernel, grid,
                                    MBT_BLOCK, args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// coeffs (host): (hi, lo) of inv_theta, then of c_d and c_r per step;
// scratch: [6, n] (r, d0, d1 as hi, lo rows); xh, xl: the [n] result.
cudaError_t mbt_cheby_chain_df(const int* offsets, int n_diags, long long n,
                               const float* valh, const float* vall,
                               const float* vh, const float* vl,
                               const float* coeffs, int degree, float* xh,
                               float* xl, float* scratch,
                               cudaStream_t stream) {
  DiaOffsets o;
  if (n < 1 || degree < 1 || degree > MBT_MAX_CHEBY_DEGREE ||
      !mbt_fill_offsets(o, offsets, n_diags))
    return cudaErrorInvalidValue;
  ChebyCoeffsDF c;
  c.degree = degree;
  c.inv_theta = {coeffs[0], coeffs[1]};
  for (int k = 0; k < degree; ++k) {
    c.cd[k] = {coeffs[2 + 4 * k], coeffs[3 + 4 * k]};
    c.cr[k] = {coeffs[4 + 4 * k], coeffs[5 + 4 * k]};
  }
  int grid = 0;
  cudaError_t err = coop_grid(cheby_df_kernel, n, &grid);
  if (err != cudaSuccess) return err;
  void* args[] = {&o, &c, &n, &valh, &vall, &vh, &vl, &xh, &xl, &scratch};
  err = cudaLaunchCooperativeKernel((const void*)cheby_df_kernel, grid,
                                    MBT_BLOCK, args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
