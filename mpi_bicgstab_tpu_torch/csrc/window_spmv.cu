// Windowed-ELL SpMV, the slab part of y = A x: float32, float64 and
// double-float (DF) pairs.
//
// Replaces: mpi_bicgstab_tpu/ops/pallas_window_spmv.py::_kernel (driver
// _window_spmv_core, entry window_spmv) and ::_df_kernel (driver
// _window_spmv_df_core, entry window_spmv_df). The layout is the JAX
// package's (ops/window_ell.py): slab-major [W, T, 8, 128] arrays, slot
// (w, t, i, j) holding row r = t * 1024 + i * 128 + j's w-th stored entry,
// whose column is
//   window_base[t] * 1024 + sub_sel[w, t, i, lam] * 128 + lam,
//   lam = lane_idx[w, t, i, j].
// The COO tail is not in this kernel: ops/window_spmv.py adds it level by
// level in PyTorch, in a fixed order.
//
// What the TPU kernel does and why this one does not: Mosaic has fast
// dynamic gathers only inside one [8, 128] register window, so the Pallas
// kernel DMAs the whole iterate into VMEM once and composes a sublane
// gather (sub_sel) with a lane gather (lane_idx), 16 tiles per grid step.
// A Hopper thread reads any address, so here one thread owns one row and
// reads lam, then s = sub_sel[w, t, i, lam] (a byte inside the 128-byte
// row its neighbours read too, so L1 serves it), then x at the column
// above (inside the tile's 1024-column window: 4 KB of x in float32 per
// tile, which L1 and L2 hold). No VMEM residency, no grid steps.
//
// Columns >= n_cols read as 0 and are never loaded: the JAX wrapper pads
// x with zeros to x_rows * 128 (_x_to_2d), the port does not pad x, and
// 0 * (whatever lies past the end) could be NaN.
//
// Bound on the H100: memory. Per slot it moves the value (4 or 8 bytes),
// lane_idx and sub_sel (1 byte each) for 2 flops (DF: one df_mul and one
// df_add, 30 float operations on 16 bytes of value and x); once per row x
// in and y out. At the main path's shapes (clustered_random(1602560),
// W = 24) that is 243.6 MB in float32 (a 72.7 us floor at 3.35 TB/s) and
// 410.2 MB in float64 and DF (122.5 us); the slots are ~3x padded, so
// the floor is the padded layout's, not the 12.8M nonzeros'. The values
// and lane_idx stream once (coalesced along j, loaded evict-first); the
// design spends nothing on the gathers beyond L1 hits.
//
// Rounding: each slab adds acc + v * xg as a rounded product and a
// rounded sum (__fmul_rn / __fadd_rn, never contracted into an FMA), in
// slab order from 0: the plain twin's sequence (ops/window_spmv.py), so
// kernel and twin agree bit for bit. The DF kernel accumulates
// acc = df_add(acc, df_mul(v, xg)) with df_core.cuh's operations, the JAX
// _df_kernel's order; its twin uses ops/precision.df_mul and df_add.
#include "df_core.cuh"

#define MBT_TILE_ROWS 1024    // rows per tile: 8 sublanes x 128 lanes
#define MBT_WINDOW_COLS 1024  // columns per window

// The x column of row r's slot in slab `slab` (an offset of w * n_rows
// into the [W, T, 8, 128] arrays); `win` is the tile's first column.
__device__ __forceinline__ long long slot_col(
    const signed char* __restrict__ sub_sel,
    const signed char* __restrict__ lane_idx, long long slab, long long r,
    long long win) {
  const int lam = __ldcs(lane_idx + slab + r);
  const int s = __ldg(sub_sel + slab + (r & ~127LL) + lam);
  return win + s * 128 + lam;
}

template <typename T>
__global__ void __launch_bounds__(MBT_BLOCK)
    window_spmv_kernel(long long n_rows, int width, long long n_cols,
                       const signed char* __restrict__ sub_sel,
                       const signed char* __restrict__ lane_idx,
                       const T* __restrict__ vals,
                       const int* __restrict__ window_base,
                       const T* __restrict__ x, T* __restrict__ y) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const long long win =
      (long long)__ldg(window_base + r / MBT_TILE_ROWS) * MBT_WINDOW_COLS;
  T acc = T(0);
  for (int w = 0; w < width; ++w) {
    const long long slab = (long long)w * n_rows;
    const long long col = slot_col(sub_sel, lane_idx, slab, r, win);
    const T v = __ldcs(vals + slab + r);
    const T xg = col < n_cols ? __ldg(x + col) : T(0);
    acc = add_rn(acc, mul_rn(v, xg));
  }
  y[r] = acc;
}

__global__ void __launch_bounds__(MBT_BLOCK)
    window_spmv_df_kernel(long long n_rows, int width, long long n_cols,
                          const signed char* __restrict__ sub_sel,
                          const signed char* __restrict__ lane_idx,
                          const float* __restrict__ vh,
                          const float* __restrict__ vl,
                          const int* __restrict__ window_base,
                          const float* __restrict__ xh,
                          const float* __restrict__ xl,
                          float* __restrict__ yh, float* __restrict__ yl) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const long long win =
      (long long)__ldg(window_base + r / MBT_TILE_ROWS) * MBT_WINDOW_COLS;
  df_t acc = {0.0f, 0.0f};
  for (int w = 0; w < width; ++w) {
    const long long slab = (long long)w * n_rows;
    const long long col = slot_col(sub_sel, lane_idx, slab, r, win);
    const df_t v = {__ldcs(vh + slab + r), __ldcs(vl + slab + r)};
    const df_t xg = col < n_cols ? ld_df(xh, xl, col) : df_t{0.0f, 0.0f};
    acc = df_add(acc, df_mul(v, xg));
  }
  st_df(yh, yl, r, acc);
}

static inline bool shape_ok(long long n_tiles, int width, long long n_cols) {
  return n_tiles >= 1 && width >= 1 && n_cols >= 1;
}

template <typename T>
static cudaError_t launch(long long n_tiles, int width, long long n_cols,
                          const signed char* sub_sel,
                          const signed char* lane_idx, const T* vals,
                          const int* window_base, const T* x, T* y,
                          cudaStream_t stream) {
  if (!shape_ok(n_tiles, width, n_cols)) return cudaErrorInvalidValue;
  const long long n_rows = n_tiles * MBT_TILE_ROWS;
  window_spmv_kernel<T><<<mbt_grid(n_rows), MBT_BLOCK, 0, stream>>>(
      n_rows, width, n_cols, sub_sel, lane_idx, vals, window_base, x, y);
  return cudaGetLastError();
}

extern "C" {

// sub_sel, lane_idx, vals: [width, n_tiles, 8, 128]; window_base:
// [n_tiles]; x: [n_cols]; y: [n_tiles * 1024].
cudaError_t mbt_window_spmv_f32(long long n_tiles, int width,
                                long long n_cols, const signed char* sub_sel,
                                const signed char* lane_idx,
                                const float* vals, const int* window_base,
                                const float* x, float* y,
                                cudaStream_t stream) {
  return launch<float>(n_tiles, width, n_cols, sub_sel, lane_idx, vals,
                       window_base, x, y, stream);
}

cudaError_t mbt_window_spmv_f64(long long n_tiles, int width,
                                long long n_cols, const signed char* sub_sel,
                                const signed char* lane_idx,
                                const double* vals, const int* window_base,
                                const double* x, double* y,
                                cudaStream_t stream) {
  return launch<double>(n_tiles, width, n_cols, sub_sel, lane_idx, vals,
                        window_base, x, y, stream);
}

// DF: vals, x and y as (hi, lo) float arrays of the shapes above.
cudaError_t mbt_window_spmv_df(long long n_tiles, int width,
                               long long n_cols, const signed char* sub_sel,
                               const signed char* lane_idx,
                               const float* vals_hi, const float* vals_lo,
                               const int* window_base, const float* x_hi,
                               const float* x_lo, float* y_hi, float* y_lo,
                               cudaStream_t stream) {
  if (!shape_ok(n_tiles, width, n_cols)) return cudaErrorInvalidValue;
  const long long n_rows = n_tiles * MBT_TILE_ROWS;
  window_spmv_df_kernel<<<mbt_grid(n_rows), MBT_BLOCK, 0, stream>>>(
      n_rows, width, n_cols, sub_sel, lane_idx, vals_hi, vals_lo,
      window_base, x_hi, x_lo, y_hi, y_lo);
  return cudaGetLastError();
}

}  // extern "C"
