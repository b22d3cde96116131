// Windowed-ELL SpMV y = A x over the layout's row-compacted copy:
// float32, float64 and double-float (DF) pairs. One launch is the whole
// product, the COO tail included.
//
// Replaces: mpi_bicgstab_tpu/ops/pallas_window_spmv.py::_kernel (line 43;
// driver _window_spmv_core, entry window_spmv) and ::_df_kernel (line 122;
// driver _window_spmv_df_core, entry window_spmv_df), with the COO tail
// that the JAX package adds after them.
//
// The copy (ops/window_ell.py, WindowEllMatrix.rc_*) is SELL-32: rows in
// slices of 32, slice s holding rc_off[s + 1] - rc_off[s] slots, row
// 32 s + l's k-th entry at slot rc_off[s] + 32 k + l, each slice as wide
// as its longest row. A row's list is its held slab entries in slab order,
// then its tail entries in level order; rc_col is the entry's x column,
// -1 for an empty slot. One thread owns one row, a warp one slice: each
// step loads rc_col and rc_val coalesced (evict-first, read once), then
// gathers x[col] through L1 (a tile's 1024-column window is 4 KB of x in
// float32) and adds it. y is written once; no atomics, no second pass.
//
// Why not the TPU's design: Mosaic has fast dynamic gathers only inside
// one [8, 128] register window, so JAX's build edge-colours the entries
// into W slabs (each lane class once per tile row and slab) and its kernel
// composes a sublane gather (sub_sel) with a lane gather (lane_idx). The
// colouring pads: on clustered_random(1602560) W = 24 slabs hold
// 38,461,440 slots for 12,777,231 nonzeros. A Hopper thread reads any
// address, so the colouring buys nothing here; the compacted copy holds
// 12,820,480 slots (1.0034x the nonzeros) and folds the tail's 34,282
// entries in, where the padded kernel left them to PyTorch launches level
// by level.
//
// Bound on the H100: memory. The work needs each nonzero's value and its
// int32 column once, x read once and y written once: at the main path's
// shape 115.0 MB in float32 (34.3 us at 3.35 TB/s) and 179.0 MB in
// float64 and DF (53.4 us). This design streams its 12.82M slots (4 bytes
// of column and 4 or 8 of value each) and rc_off: within 0.4% of that.
// DF does 30 float operations a nonzero (df_mul, df_add) on 16 bytes of
// value and x: still far below the card's float32 rate.
//
// Rounding: each entry adds acc + v * xg as a rounded product and a
// rounded sum (__fmul_rn / __fadd_rn, never contracted into an FMA), in
// the list's order from acc = +0; DF accumulates acc = df_add(acc,
// df_mul(v, xg)) with df_core.cuh's operations. The plain twins
// (ops/window_spmv.py: window_rows_plain, window_rows_df_plain) do the
// same, so kernel and twin agree bit for bit on every x. Against the
// padded slabs plus the leveled tail (the JAX order) the result is
// bit-equal for every finite x: a padded slot adds v * xg = +-0, which
// leaves the accumulator as it was. A NaN or an inf that only padded
// slots point to no longer reaches the row.
#include "df_core.cuh"

#define MBT_SLICE_ROWS 32  // rows per slice: one warp

template <typename T>
__global__ void __launch_bounds__(MBT_BLOCK)
    window_rows_kernel(long long n_rows, const long long* __restrict__ rc_off,
                       const int* __restrict__ rc_col,
                       const T* __restrict__ rc_val,
                       const T* __restrict__ x, T* __restrict__ y) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const long long s = r / MBT_SLICE_ROWS;
  const long long end = __ldg(rc_off + s + 1);
  T acc = T(0);
  for (long long p = __ldg(rc_off + s) + (r % MBT_SLICE_ROWS); p < end;
       p += MBT_SLICE_ROWS) {
    const int col = __ldcs(rc_col + p);
    const T v = __ldcs(rc_val + p);
    if (col >= 0) acc = add_rn(acc, mul_rn(v, __ldg(x + col)));
  }
  y[r] = acc;
}

__global__ void __launch_bounds__(MBT_BLOCK)
    window_rows_df_kernel(long long n_rows,
                          const long long* __restrict__ rc_off,
                          const int* __restrict__ rc_col,
                          const float* __restrict__ vh,
                          const float* __restrict__ vl,
                          const float* __restrict__ xh,
                          const float* __restrict__ xl,
                          float* __restrict__ yh, float* __restrict__ yl) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const long long s = r / MBT_SLICE_ROWS;
  const long long end = __ldg(rc_off + s + 1);
  df_t acc = {0.0f, 0.0f};
  for (long long p = __ldg(rc_off + s) + (r % MBT_SLICE_ROWS); p < end;
       p += MBT_SLICE_ROWS) {
    const int col = __ldcs(rc_col + p);
    const df_t v = {__ldcs(vh + p), __ldcs(vl + p)};
    if (col >= 0) acc = df_add(acc, df_mul(v, ld_df(xh, xl, col)));
  }
  st_df(yh, yl, r, acc);
}

static inline bool shape_ok(long long n_rows) {
  return n_rows >= MBT_SLICE_ROWS && n_rows % MBT_SLICE_ROWS == 0;
}

template <typename T>
static cudaError_t launch(long long n_rows, const long long* rc_off,
                          const int* rc_col, const T* rc_val, const T* x,
                          T* y, cudaStream_t stream) {
  if (!shape_ok(n_rows)) return cudaErrorInvalidValue;
  window_rows_kernel<T><<<mbt_grid(n_rows), MBT_BLOCK, 0, stream>>>(
      n_rows, rc_off, rc_col, rc_val, x, y);
  return cudaGetLastError();
}

extern "C" {

// rc_off: [n_rows / 32 + 1]; rc_col, rc_val: [rc_off[n_rows / 32]];
// x: [n_cols] (every rc_col >= 0 below n_cols); y: [n_rows].
cudaError_t mbt_window_rows_f32(long long n_rows, const long long* rc_off,
                                const int* rc_col, const float* rc_val,
                                const float* x, float* y,
                                cudaStream_t stream) {
  return launch<float>(n_rows, rc_off, rc_col, rc_val, x, y, stream);
}

cudaError_t mbt_window_rows_f64(long long n_rows, const long long* rc_off,
                                const int* rc_col, const double* rc_val,
                                const double* x, double* y,
                                cudaStream_t stream) {
  return launch<double>(n_rows, rc_off, rc_col, rc_val, x, y, stream);
}

// DF: rc_val, x and y as (hi, lo) float arrays of the shapes above.
cudaError_t mbt_window_rows_df(long long n_rows, const long long* rc_off,
                               const int* rc_col, const float* val_hi,
                               const float* val_lo, const float* x_hi,
                               const float* x_lo, float* y_hi, float* y_lo,
                               cudaStream_t stream) {
  if (!shape_ok(n_rows)) return cudaErrorInvalidValue;
  window_rows_df_kernel<<<mbt_grid(n_rows), MBT_BLOCK, 0, stream>>>(
      n_rows, rc_off, rc_col, val_hi, val_lo, x_hi, x_lo, y_hi, y_lo);
  return cudaGetLastError();
}

}  // extern "C"
