// Butterfly-routed SpMV (ops/butterfly.py, ops/butterfly_spmv.py): K1 and
// K2 (routed copies of 4- and 8-byte elements), which build the layout's
// column table once, and K3 (the SpMV over x through that table: float32,
// float64 and double-float pairs).
//
// Replaces: mpi_bicgstab_tpu/ops/pallas_butterfly.py::_k1_kernel (driver
// _k1), ::_k2_kernel (_k2), ::_k3_kernel (_k3, its 'lane' variant) and
// ::_k3_df_kernel (_k3_df). K1's and K2's tables are the JAX package's:
// [P, 8, 128] int8 pairs (sublane, lane) in which slot (i, j) of a window
// reads window element sub[i, lam] * 128 + lam with lam = lane[i, j] (the
// sublane table indexed by the SOURCE lane). K3's tables are
// [W//8, 8, NR, 128], which is [W, n_pad] byte for byte, so slab w of
// row r sits at w * n_pad + r.
//
// What the TPU kernels do and why these do not: Mosaic gathers only
// inside one [8, 128] register window, so JAX factors the random gather
// x -> z of every SpMV into K1, a transpose, K2 and a transpose, and K3
// reads z with chained sublane and lane gathers. The route depends only on
// the layout: every element of z is one column of x, or K1's zero. A
// Hopper thread reads any address, and x (6.4 MB in float32, 12.8 MB in
// float64 or DF at the main path's shapes) sits in the 50 MB L2, so the
// port routes once per layout: K1 and K2 move the int32 iota 1..n_cols
// (b32), the transposes and one gather in PyTorch finish the column table
// k3_col (ops/butterfly_spmv.column_table), and each SpMV is one K3 pass
// that streams k3_col and the values and gathers x by column. K1 and K2
// keep one thread per output slot, reading lam, then the sublane byte in
// the same 128-byte table row (an L1 hit), then its element of the
// window; K1 reads 0 for a column >= n_cols (JAX zero-pads x to nc_pad,
// the port passes x unpadded).
//
// K3: a thread owns R consecutive rows (R = 1 in float32, 2 in float64
// and DF: MBT_K3_ROWS_*, chosen by measurement on the H100, PERF.md); per
// chunk of 8 slabs it loads the 8 x R columns and values (R * 4 bytes of
// columns and R elements of values in one vector load a slab,
// evict-first: they are read once), then the 8 x R gathers of x (__ldg),
// then accumulates. A -1 column reads +0 without a load (the bits K1
// writes past the last column), and its product is formed like any
// other, so the result is the routed pipeline's bit for bit, NaN, inf and
// the sign of zero included.
//
// Rounding: K3 keeps 8 accumulators a row, slab w adding to accumulator
// w % 8 as JAX's [8, 128] accumulator does (chunk by chunk over the W/8
// chunks), each step a rounded product and a rounded sum (mul_rn /
// add_rn, never an FMA); then the 8 sums combine by halving, a[i] +
// a[i + h] for h = 4, 2, 1. The DF kernel accumulates with df_fma in JAX's
// order and halves with two_sum, the low parts added as (e[i] + e[i + h])
// + err (pallas_butterfly.py:342-352); its output pair is not
// renormalised, as in JAX. It gathers x as packed (hi, lo) pairs, one
// 8-byte load a slot (the wrapper packs x once per SpMV). The plain twins
// (ops/butterfly_spmv.py) do the same operations, so every kernel is
// bit-equal to its twin.
//
// Bound on the H100: memory. At the main path's shapes (uniform:1602112
// padded to 1,602,560 rows: P = 25,600 windows, rb = 64, W = 16, n_pad =
// 1,603,584) K3 reads 25,657,344 columns (102.6 MB) and as many values
// (102.6 MB in float32, 205.3 in float64 and DF), x once and writes y:
// 218 MB (65.1 us at 3.35 TB/s) in float32, 333.5 MB (99.6 us) in
// float64 and DF, and gathers x for the 12.8M slots that hold a
// nonzero (a slab's padded slots in one row tile all name one column).
// K1 moves its two
// int8 tables, k1_src, x and u1 (163.8 MB in b32, 48.9 us), K2 the tables,
// mid and z1 (262.1 MB, 78.3 us): once per layout.
#include <cstdint>
#include <cstring>

#include "df_core.cuh"

#define MBT_BFLY_WIN 1024  // window: 8 sublanes x 128 lanes
#define MBT_BFLY_SUB 8     // K3 accumulators: slabs per chunk
#define MBT_K3_ROWS_F32 1  // K3's rows a thread: float32
#define MBT_K3_ROWS_F64 2  // float64 and DF

// lam = lane[i], then the window element sub[row of i, lam] * 128 + lam
// of the slot's window (an offset within the window).
__device__ __forceinline__ int slot_elem(const signed char* __restrict__ sub,
                                         const signed char* __restrict__ lane,
                                         long long i) {
  const int lam = __ldcs(lane + i);
  return __ldg(sub + (i & ~127LL) + lam) * 128 + lam;
}

// K1: u1[i] = x[k1_src[a] * 1024 + slot_elem(i)], a = i / 1024; 0 (the
// bits of +0.0) past the last column. T: a 4- or 8-byte unsigned integer.
template <typename T>
__global__ void __launch_bounds__(MBT_BLOCK)
    bfly_k1_kernel(long long n_slots, long long n_cols,
                   const int* __restrict__ src,
                   const signed char* __restrict__ sub,
                   const signed char* __restrict__ lane,
                   const T* __restrict__ x, T* __restrict__ u1) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;
  const long long col =
      (long long)__ldg(src + i / MBT_BFLY_WIN) * MBT_BFLY_WIN +
      slot_elem(sub, lane, i);
  u1[i] = col < n_cols ? __ldg(x + col) : T(0);
}

// K2: z1[i] = mid[(i / 1024) * 1024 + slot_elem(i)], a permutation inside
// each window. T as for K1.
template <typename T>
__global__ void __launch_bounds__(MBT_BLOCK)
    bfly_k2_kernel(long long n_slots, const signed char* __restrict__ sub,
                   const signed char* __restrict__ lane,
                   const T* __restrict__ mid, T* __restrict__ z1) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;
  z1[i] = __ldg(mid + (i & ~(long long)(MBT_BFLY_WIN - 1)) +
                slot_elem(sub, lane, i));
}

// R consecutive elements from p (R * sizeof(T) bytes, aligned to that
// size), read once: an evict-first vector load of 4, 8 or 16 bytes.
template <int R, typename T>
__device__ __forceinline__ void ld_stream(const T* __restrict__ p,
                                          T (&o)[R]) {
  constexpr int bytes = R * (int)sizeof(T);
  if constexpr (bytes == 16) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    memcpy(o, &v, 16);
  } else if constexpr (bytes == 8) {
    const float2 v = __ldcs(reinterpret_cast<const float2*>(p));
    memcpy(o, &v, 8);
  } else {
    static_assert(bytes == 4, "4, 8 or 16 bytes");
    const float v = __ldcs(reinterpret_cast<const float*>(p));
    memcpy(o, &v, 4);
  }
}

// R consecutive elements to p.
template <int R, typename T>
__device__ __forceinline__ void st_rows(T* __restrict__ p, const T (&v)[R]) {
#pragma unroll
  for (int k = 0; k < R; ++k) p[k] = v[k];
}

// x[c], +0 (all bits zero) for c = -1.
template <typename T>
__device__ __forceinline__ T gather(const T* __restrict__ x, int c) {
  if (c < 0) return T{};
  return __ldg(x + c);
}

// y[r] = sum over the W slabs of vals[w, r] * x[col[w, r]], rows r0 ..
// r0 + R - 1 of one thread.
template <typename T, int R>
__global__ void __launch_bounds__(MBT_BLOCK)
    bfly_k3_kernel(long long n_pad, int chunks, const int* __restrict__ col,
                   const T* __restrict__ vals, const T* __restrict__ x,
                   T* __restrict__ y) {
  const long long r0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * R;
  if (r0 >= n_pad) return;
  T acc[R][MBT_BFLY_SUB];
#pragma unroll
  for (int k = 0; k < R; ++k)
#pragma unroll
    for (int i = 0; i < MBT_BFLY_SUB; ++i) acc[k][i] = T(0);
  for (int c = 0; c < chunks; ++c) {
    int cc[MBT_BFLY_SUB][R];
    T v[MBT_BFLY_SUB][R], xg[MBT_BFLY_SUB][R];
#pragma unroll
    for (int i = 0; i < MBT_BFLY_SUB; ++i) {
      const long long at = (long long)(c * MBT_BFLY_SUB + i) * n_pad + r0;
      ld_stream<R>(col + at, cc[i]);
      ld_stream<R>(vals + at, v[i]);
    }
#pragma unroll
    for (int i = 0; i < MBT_BFLY_SUB; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) xg[i][k] = gather(x, cc[i][k]);
#pragma unroll
    for (int i = 0; i < MBT_BFLY_SUB; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k)
        acc[k][i] = add_rn(acc[k][i], mul_rn(v[i][k], xg[i][k]));
  }
  T out[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
#pragma unroll
    for (int h = MBT_BFLY_SUB / 2; h >= 1; h >>= 1) {
#pragma unroll
      for (int i = 0; i < h; ++i) acc[k][i] = add_rn(acc[k][i], acc[k][i + h]);
    }
    out[k] = acc[k][0];
  }
  st_rows<R>(y + r0, out);
}

// The DF form: values as (hi, lo) planes, x as packed (hi, lo) pairs.
template <int R>
__global__ void __launch_bounds__(MBT_BLOCK)
    bfly_k3_df_kernel(long long n_pad, int chunks,
                      const int* __restrict__ col,
                      const float* __restrict__ vh,
                      const float* __restrict__ vl,
                      const float2* __restrict__ x, float* __restrict__ yh,
                      float* __restrict__ yl) {
  const long long r0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * R;
  if (r0 >= n_pad) return;
  df_t acc[R][MBT_BFLY_SUB];
#pragma unroll
  for (int k = 0; k < R; ++k)
#pragma unroll
    for (int i = 0; i < MBT_BFLY_SUB; ++i) acc[k][i] = {0.0f, 0.0f};
  for (int c = 0; c < chunks; ++c) {
    int cc[MBT_BFLY_SUB][R];
    float h[MBT_BFLY_SUB][R], l[MBT_BFLY_SUB][R];
    float2 xg[MBT_BFLY_SUB][R];
#pragma unroll
    for (int i = 0; i < MBT_BFLY_SUB; ++i) {
      const long long at = (long long)(c * MBT_BFLY_SUB + i) * n_pad + r0;
      ld_stream<R>(col + at, cc[i]);
      ld_stream<R>(vh + at, h[i]);
      ld_stream<R>(vl + at, l[i]);
    }
#pragma unroll
    for (int i = 0; i < MBT_BFLY_SUB; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k) xg[i][k] = gather(x, cc[i][k]);
#pragma unroll
    for (int i = 0; i < MBT_BFLY_SUB; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k)
        acc[k][i] = df_fma(acc[k][i], df_t{h[i][k], l[i][k]},
                           df_t{xg[i][k].x, xg[i][k].y});
  }
  // the 8 sums by compensated halving: the high parts by two_sum, the
  // low parts and the rounding errors added, no renormalisation
  float oh[R], ol[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
#pragma unroll
    for (int hh = MBT_BFLY_SUB / 2; hh >= 1; hh >>= 1) {
#pragma unroll
      for (int i = 0; i < hh; ++i) {
        const df_t s = two_sum(acc[k][i].hi, acc[k][i + hh].hi);
        acc[k][i] = {s.hi, __fadd_rn(__fadd_rn(acc[k][i].lo,
                                               acc[k][i + hh].lo), s.lo)};
      }
    }
    oh[k] = acc[k][0].hi;
    ol[k] = acc[k][0].lo;
  }
  st_rows<R>(yh + r0, oh);
  st_rows<R>(yl + r0, ol);
}

// K3's rows: whole row tiles; slabs: whole chunks of 8; the streamed
// tables aligned for the R-wide vector loads.
static inline bool k3_args_ok(long long n_pad, int width, const void* col,
                              const void* vals) {
  return n_pad >= 128 && n_pad % 128 == 0 && width >= MBT_BFLY_SUB &&
         width % MBT_BFLY_SUB == 0 &&
         ((uintptr_t)col | (uintptr_t)vals) % 16 == 0;
}

template <typename T>
static cudaError_t launch_k1(long long P, long long n_cols, const int* src,
                             const signed char* sub, const signed char* lane,
                             const T* x, T* u1, cudaStream_t stream) {
  if (P < 1 || n_cols < 1) return cudaErrorInvalidValue;
  const long long n_slots = P * MBT_BFLY_WIN;
  bfly_k1_kernel<T><<<mbt_grid(n_slots), MBT_BLOCK, 0, stream>>>(
      n_slots, n_cols, src, sub, lane, x, u1);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_k2(long long P, const signed char* sub,
                             const signed char* lane, const T* mid, T* z1,
                             cudaStream_t stream) {
  if (P < 1) return cudaErrorInvalidValue;
  const long long n_slots = P * MBT_BFLY_WIN;
  bfly_k2_kernel<T><<<mbt_grid(n_slots), MBT_BLOCK, 0, stream>>>(
      n_slots, sub, lane, mid, z1);
  return cudaGetLastError();
}

template <typename T, int R>
static cudaError_t launch_k3(long long n_pad, int width, const int* col,
                             const T* vals, const T* x, T* y,
                             cudaStream_t stream) {
  if (!k3_args_ok(n_pad, width, col, vals)) return cudaErrorInvalidValue;
  bfly_k3_kernel<T, R><<<mbt_grid(n_pad / R), MBT_BLOCK, 0, stream>>>(
      n_pad, width / MBT_BFLY_SUB, col, vals, x, y);
  return cudaGetLastError();
}

extern "C" {

// K1: k1_src [P] int32; k1_sub, k1_lane [P, 8, 128] int8; x [n_cols];
// u1 [P * 1024]; elements of 4 bytes (b32) or 8 bytes (b64).
cudaError_t mbt_bfly_k1_b32(long long P, long long n_cols, const int* src,
                            const signed char* sub, const signed char* lane,
                            const unsigned int* x, unsigned int* u1,
                            cudaStream_t stream) {
  return launch_k1(P, n_cols, src, sub, lane, x, u1, stream);
}

cudaError_t mbt_bfly_k1_b64(long long P, long long n_cols, const int* src,
                            const signed char* sub, const signed char* lane,
                            const unsigned long long* x,
                            unsigned long long* u1, cudaStream_t stream) {
  return launch_k1(P, n_cols, src, sub, lane, x, u1, stream);
}

// K2: k2_sub, k2_lane [P, 8, 128] int8; mid, z1 [P * 1024].
cudaError_t mbt_bfly_k2_b32(long long P, const signed char* sub,
                            const signed char* lane, const unsigned int* mid,
                            unsigned int* z1, cudaStream_t stream) {
  return launch_k2(P, sub, lane, mid, z1, stream);
}

cudaError_t mbt_bfly_k2_b64(long long P, const signed char* sub,
                            const signed char* lane,
                            const unsigned long long* mid,
                            unsigned long long* z1, cudaStream_t stream) {
  return launch_k2(P, sub, lane, mid, z1, stream);
}

// K3: k3_col (int32) and vals [width, n_pad] (the [W//8, 8, NR, 128]
// tables); x [n_cols]; y [n_pad].
cudaError_t mbt_bfly_k3_f32(long long n_pad, int width, const int* col,
                            const float* vals, const float* x, float* y,
                            cudaStream_t stream) {
  return launch_k3<float, MBT_K3_ROWS_F32>(n_pad, width, col, vals, x, y,
                                           stream);
}

cudaError_t mbt_bfly_k3_f64(long long n_pad, int width, const int* col,
                            const double* vals, const double* x, double* y,
                            cudaStream_t stream) {
  return launch_k3<double, MBT_K3_ROWS_F64>(n_pad, width, col, vals, x, y,
                                            stream);
}

// K3 in DF: vals and y as (hi, lo) float arrays of the shapes above; x
// the packed pairs, (hi, lo) interleaved.
cudaError_t mbt_bfly_k3_df(long long n_pad, int width, const int* col,
                           const float* vals_hi, const float* vals_lo,
                           const float2* x, float* y_hi, float* y_lo,
                           cudaStream_t stream) {
  if (!k3_args_ok(n_pad, width, col, vals_hi) ||
      (uintptr_t)vals_lo % 16 != 0)
    return cudaErrorInvalidValue;
  constexpr int R = MBT_K3_ROWS_F64;
  bfly_k3_df_kernel<R><<<mbt_grid(n_pad / R), MBT_BLOCK, 0, stream>>>(
      n_pad, width / MBT_BFLY_SUB, col, vals_hi, vals_lo, x, y_hi, y_lo);
  return cudaGetLastError();
}

}  // extern "C"
