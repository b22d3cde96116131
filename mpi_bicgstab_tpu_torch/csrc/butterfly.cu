// Butterfly-routed SpMV stages (ops/butterfly.py, ops/butterfly_spmv.py):
// K1 and K2 (routed copies of 4- and 8-byte elements) and K3 (the SpMV
// from the routed vector: float32, float64 and double-float pairs).
//
// Replaces: mpi_bicgstab_tpu/ops/pallas_butterfly.py::_k1_kernel (driver
// _k1), ::_k2_kernel (_k2), ::_k3_kernel (_k3, its 'lane' variant) and
// ::_k3_df_kernel (_k3_df). The tables are the JAX package's: K1 and K2
// [P, 8, 128] int8 pairs (sublane, lane) in which slot (i, j) of a window
// reads window element sub[i, lam] * 128 + lam with lam = lane[i, j] (the
// sublane table indexed by the SOURCE lane); K3's [W//8, 8, NR, 128]
// tables, which are [W, n_pad] byte for byte, so slab w of row r sits at
// w * n_pad + r. The two transposes between the stages and the leveled
// tail stay in PyTorch (ops/butterfly_spmv.py), as they are XLA code in
// the JAX package.
//
// What the TPU kernels do and why these do not: Mosaic gathers only
// inside one [8, 128] register window, so the Pallas kernels chain a
// sublane gather and a lane gather per window, DMA the whole iterate into
// VMEM for K1, and in K3 select between the F = 128 / rb stacked windows
// with a lane mask. A Hopper thread reads any address: here one thread
// owns one output slot (K1, K2) or one output row (K3) and reads lam,
// then the sublane byte in the same 128-byte table row (its warp reads
// that row too: an L1 hit), then its element of the window (K1: a 4 KB
// window of x in float32; K2: the slot's own window of mid; K3: the row
// tile's 8F x 128-element stacked block of z, 8 KB in float32), which L1
// and L2 serve. No residency, no grid steps.
//
// K1 reads 0 for a column >= n_cols and never loads it: the JAX pipeline
// zero-pads x to nc_pad, the port passes x unpadded.
//
// K3 takes the window of output lane j as f = j / rb and the sublane as
// (s & 7) within it: the Pallas 'lane' form. The router stores s =
// (row % 128) / rb * 8 + slot / 128, so for every placed slot this is the
// element JAX's XLA form (the full stacked sublane s) reads too; padded
// slots carry value 0.
//
// Rounding: K3 keeps 8 accumulators, slab w adding to accumulator w % 8
// as JAX's [8, 128] accumulator does (chunk by chunk over the W/8 chunks),
// each step a rounded product and a rounded sum (mul_rn / add_rn, never an
// FMA); then the 8 sums combine by halving, a[i] + a[i + h] for h = 4, 2,
// 1. The DF kernel accumulates with df_fma in JAX's order and halves with
// two_sum, the low parts added as (e[i] + e[i + h]) + err
// (pallas_butterfly.py:342-352); its output pair is not renormalised, as
// in JAX. The plain twins (ops/butterfly_spmv.py) do the same operations,
// so every kernel is bit-equal to its twin.
//
// Bound on the H100: memory. At the main path's shapes (uniform:1602112
// padded to 1,602,560 rows: P = 25,600 windows, rb = 64, W = 16, n_pad =
// 1,603,584) K1 moves its two int8 tables, k1_src, x and u1: 163.8 MB in
// float32 (a 48.9 us floor at 3.35 TB/s), 274.9 MB in float64; K2 the two
// tables, mid and z1: 262.1 MB (78.3 us), 471.9 MB; K3 the three slab
// tables, the z windows it reads and y: 262.9 MB (78.5 us), 474.7 MB in
// float64 and DF. A DF vector is routed in one K1 and one K2 launch that
// move both planes: each (hi, lo) pair travels as one 8-byte element
// (ops/butterfly_spmv.pack_df), so the tables are read once, not once per
// plane, and K3 DF reads the pair with one 8-byte load. K1 and K2 copy
// bits (unsigned integer elements), never values. The design spends
// nothing on the gathers beyond L1 and L2 hits; tables and values stream
// once, loaded evict-first.
#include "df_core.cuh"

#define MBT_BFLY_WIN 1024  // window: 8 sublanes x 128 lanes
#define MBT_BFLY_SUB 8     // K3 accumulators: slabs per chunk

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

// K3's gather for slab offset `at` = w * n_pad + r: the element of z that
// row r's entry in that slab reads. `block` is the row tile's first
// element of z plus its window's (row % 128 / rb) sublane offset.
__device__ __forceinline__ long long k3_elem(
    const signed char* __restrict__ sub,
    const signed char* __restrict__ lane, long long at, long long block) {
  const int lam = __ldcs(lane + at);
  const int s = __ldg(sub + (at & ~127LL) + lam) & (MBT_BFLY_SUB - 1);
  return block + s * 128 + lam;
}

__device__ __forceinline__ long long k3_block(long long r, int rb) {
  const long long tile = r >> 7;
  const int j = (int)(r & 127);
  return (tile * MBT_BFLY_SUB * (128 / rb) + (j / rb) * MBT_BFLY_SUB) * 128;
}

template <typename T>
__global__ void __launch_bounds__(MBT_BLOCK)
    bfly_k3_kernel(long long n_pad, int chunks, int rb,
                   const signed char* __restrict__ sub,
                   const signed char* __restrict__ lane,
                   const T* __restrict__ vals, const T* __restrict__ z,
                   T* __restrict__ y) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_pad) return;
  const long long block = k3_block(r, rb);
  T acc[MBT_BFLY_SUB];
#pragma unroll
  for (int i = 0; i < MBT_BFLY_SUB; ++i) acc[i] = T(0);
  for (int c = 0; c < chunks; ++c) {
#pragma unroll
    for (int i = 0; i < MBT_BFLY_SUB; ++i) {
      const long long at = (long long)(c * MBT_BFLY_SUB + i) * n_pad + r;
      const T xg = __ldg(z + k3_elem(sub, lane, at, block));
      acc[i] = add_rn(acc[i], mul_rn(__ldcs(vals + at), xg));
    }
  }
#pragma unroll
  for (int h = MBT_BFLY_SUB / 2; h >= 1; h >>= 1) {
#pragma unroll
    for (int i = 0; i < h; ++i) acc[i] = add_rn(acc[i], acc[i + h]);
  }
  y[r] = acc[0];
}

// z: the routed DF vector, one (hi, lo) pair per element.
__global__ void __launch_bounds__(MBT_BLOCK)
    bfly_k3_df_kernel(long long n_pad, int chunks, int rb,
                      const signed char* __restrict__ sub,
                      const signed char* __restrict__ lane,
                      const float* __restrict__ vh,
                      const float* __restrict__ vl,
                      const float2* __restrict__ z, float* __restrict__ yh,
                      float* __restrict__ yl) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_pad) return;
  const long long block = k3_block(r, rb);
  df_t acc[MBT_BFLY_SUB];
#pragma unroll
  for (int i = 0; i < MBT_BFLY_SUB; ++i) acc[i] = {0.0f, 0.0f};
  for (int c = 0; c < chunks; ++c) {
#pragma unroll
    for (int i = 0; i < MBT_BFLY_SUB; ++i) {
      const long long at = (long long)(c * MBT_BFLY_SUB + i) * n_pad + r;
      const float2 zp = __ldg(z + k3_elem(sub, lane, at, block));
      const df_t xg = {zp.x, zp.y};
      const df_t v = {__ldcs(vh + at), __ldcs(vl + at)};
      acc[i] = df_fma(acc[i], v, xg);
    }
  }
  // the 8 sums by compensated halving: the high parts by two_sum, the
  // low parts and the rounding errors added, no renormalisation
#pragma unroll
  for (int h = MBT_BFLY_SUB / 2; h >= 1; h >>= 1) {
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const df_t s = two_sum(acc[i].hi, acc[i + h].hi);
      acc[i] = {s.hi, __fadd_rn(__fadd_rn(acc[i].lo, acc[i + h].lo), s.lo)};
    }
  }
  st_df(yh, yl, r, acc[0]);
}

static inline bool k3_shape_ok(long long n_pad, int width, int rb) {
  return n_pad >= 1 && n_pad % 128 == 0 && width >= MBT_BFLY_SUB &&
         width % MBT_BFLY_SUB == 0 && (rb == 16 || rb == 32 || rb == 64);
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

template <typename T>
static cudaError_t launch_k3(long long n_pad, int width, int rb,
                             const signed char* sub, const signed char* lane,
                             const T* vals, const T* z, T* y,
                             cudaStream_t stream) {
  if (!k3_shape_ok(n_pad, width, rb)) return cudaErrorInvalidValue;
  bfly_k3_kernel<T><<<mbt_grid(n_pad), MBT_BLOCK, 0, stream>>>(
      n_pad, width / MBT_BFLY_SUB, rb, sub, lane, vals, z, y);
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

// K3: k3_sub, k3_lane, vals [width, n_pad] (the [W//8, 8, NR, 128]
// tables); z covers n_pad / rb windows of 1024; y [n_pad].
cudaError_t mbt_bfly_k3_f32(long long n_pad, int width, int rb,
                            const signed char* sub, const signed char* lane,
                            const float* vals, const float* z, float* y,
                            cudaStream_t stream) {
  return launch_k3<float>(n_pad, width, rb, sub, lane, vals, z, y, stream);
}

cudaError_t mbt_bfly_k3_f64(long long n_pad, int width, int rb,
                            const signed char* sub, const signed char* lane,
                            const double* vals, const double* z, double* y,
                            cudaStream_t stream) {
  return launch_k3<double>(n_pad, width, rb, sub, lane, vals, z, y, stream);
}

// K3 in DF: vals and y as (hi, lo) float arrays of the shapes above; z
// the routed pairs, (hi, lo) interleaved.
cudaError_t mbt_bfly_k3_df(long long n_pad, int width, int rb,
                           const signed char* sub, const signed char* lane,
                           const float* vals_hi, const float* vals_lo,
                           const float2* z, float* y_hi, float* y_lo,
                           cudaStream_t stream) {
  if (!k3_shape_ok(n_pad, width, rb)) return cudaErrorInvalidValue;
  bfly_k3_df_kernel<<<mbt_grid(n_pad), MBT_BLOCK, 0, stream>>>(
      n_pad, width / MBT_BFLY_SUB, rb, sub, lane, vals_hi, vals_lo, z,
      y_hi, y_lo);
  return cudaGetLastError();
}

}  // extern "C"
