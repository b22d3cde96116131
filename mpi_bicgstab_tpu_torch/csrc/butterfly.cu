// Butterfly-routed SpMV (ops/butterfly.py, ops/butterfly_spmv.py): K1 and
// K2 (routed copies of 4- and 8-byte elements, each writing its output in
// the transposed order) and the slot decode, which build the layout's
// column table once, and K3 (the SpMV over x through that table: float32,
// float64 and double-float pairs).
//
// Replaces: mpi_bicgstab_tpu/ops/pallas_butterfly.py::_k1_kernel (driver
// _k1) with the transpose T1 after it, ::_k2_kernel (_k2) with T2,
// ::_k3_kernel (_k3, its 'lane' variant) and ::_k3_df_kernel (_k3_df).
// K1's and K2's tables are the JAX package's: [P, 8, 128] int8 pairs
// (sublane, lane) in which slot (i, j) of a window reads window element
// sub[i, lam] * 128 + lam with lam = lane[i, j] (the sublane table indexed
// by the SOURCE lane). K3's tables are [W//8, 8, NR, 128], which is [W,
// n_pad] byte for byte, so slab w of row r sits at w * n_pad + r.
//
// What the TPU kernels do and why these do not: Mosaic gathers only
// inside one [8, 128] register window, so JAX factors the random gather
// x -> z of every SpMV into K1, a transpose, K2 and a transpose, and K3
// reads z with chained sublane and lane gathers. The route depends only on
// the layout: every element of z is one column of x, or K1's zero. A
// Hopper thread reads any address, and x (6.4 MB in float32, 12.8 MB in
// float64 or DF at the main path's shapes) sits in the 50 MB L2, so the
// port routes once per layout: K1 and K2 move the int32 iota 1..n_cols
// (b32) to z, and the decode turns z into the column table k3_col
// (ops/butterfly_spmv.column_table); each SpMV is one K3 pass that streams
// k3_col and the values and gathers x by column.
//
// K1 and K2 (one kernel, bfly_route_kernel): a block owns G consecutive
// windows a0 .. a0 + G - 1 and stages, for all of them at once, the source
// window (K1: x's window k1_src[a], 0 past the last column, as JAX
// zero-pads x; K2: window a of its input), the sublane and the lane table
// rows in shared memory by one-dimensional bulk copies (cp.async.bulk,
// the TMA's copy engine) that complete on one mbarrier: G x 6 KB (b32) in
// flight a block, two blocks an SM. The transposed tile out[e * P + a0 +
// g] is then formed in registers: a thread takes slot e of V = 16 /
// sizeof(T) consecutive windows, gathers each one's element from shared
// memory and stores the V elements as one 16-byte vector, evict-first
// (the 105 MB written do not stay in L2 for the next kernel anyway), so
// a warp writes whole runs of G elements (64 bytes) and no transpose
// follows. The partial last block (P not a multiple of G) stores element
// by element. Measured on the H100 (PERF.md): evict-first stores are
// 1.13-1.23x faster than plain ones; G = 4 V (MBT_ROUTE_VECS) because
// runs of 32 bytes (G = 2 V) cost 1.7x those of 64; 16-byte loads in
// place of the bulk copies, G = 8 V (one block an SM), two buffers walked
// by resident blocks, 512 threads, a warp-transposed store and tables
// read through L1 were all slower.
//
// The decode (bfly_decode_kernel; no TPU kernel: the part of _k3_kernel's
// gather that the port moved into the table): slot (w, r), r = R * 128 +
// j, reads lam = k3_lane[w, r], s = k3_sub[w, R * 128 + lam] and writes
// k3_col[w, r] = z[((R * stack + j / rb) * 8 + (s & 7)) * 128 + lam] - 1
// (z holds the routed iota 1..n_cols, 0 for K1's zero). A block owns one
// 128-row tile and every slab of it: its stack windows of z arrive by
// one bulk copy, and the 8 threads of a slab load and store 128
// contiguous bytes an instruction (stores of 16 bytes 64 bytes apart were
// 1.2x slower).
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
// Once per layout, K1 moves its two int8 tables, k1_src, x and mid
// (163.8 MB in b32, 48.9 us), K2 the tables, mid and z (262.1 MB, 78.3
// us), the decode K3's two int8 tables (51.3 MB), the elements of z its
// slots name (51.5 MB: a slab's padded slots in a row tile share one)
// and k3_col (102.6 MB): 61.3 us; this design stages the whole of z
// (104.9 MB).
#include <cstdint>
#include <cstring>

#include "df_core.cuh"

#define MBT_BFLY_WIN 1024  // window: 8 sublanes x 128 lanes
#define MBT_BFLY_SUB 8     // K3 accumulators: slabs per chunk
#define MBT_K3_ROWS_F32 1  // K3's rows a thread: float32
#define MBT_K3_ROWS_F64 2  // float64 and DF
#define MBT_ROUTE_THREADS 256
#define MBT_ROUTE_VECS 4     // 16-byte vectors in a slot's run: G = 4 V
#define MBT_ROUTE_HEAD 128   // shared memory before the windows: the
                             // mbarrier and the G source window numbers
#define MBT_DECODE_THREADS 128

// --- the bulk-copy path: an mbarrier in shared memory and cp.async.bulk

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the barrier's phase of parity `phase` to complete (all its
// expected bytes arrived).
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned phase) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(phase)
        : "memory");
  }
}

// bytes (a multiple of 16; both addresses 16-byte aligned) from global to
// shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The elements of window w that lie below limit, in whole 16-byte
// vectors: what its bulk copy moves.
template <typename T>
__device__ __forceinline__ int route_copied(long long limit, int w) {
  const long long left = limit - (long long)w * MBT_BFLY_WIN;
  const int valid = left <= 0 ? 0 : left >= MBT_BFLY_WIN ? MBT_BFLY_WIN
                                                         : (int)left;
  return valid & ~(16 / (int)sizeof(T) - 1);
}

// K1 (src = k1_src: window a reads x's window src[a]) and K2 (src =
// nullptr: window a reads window a of its input): out[e * P + a] =
// in[base(a) + sub[a, i, lam] * 128 + lam] for slot e = 128 i + j of
// window a, lam = lane[a, i, j]; 0 (all bits clear) where base(a) + that
// element >= limit. T: a 4- or 8-byte unsigned integer. Block b stages
// the G windows a0 = b G .. a0 + G - 1 (G a multiple of V) and their
// table rows by bulk copies; then item (e, c) gathers slot e of windows
// c V .. c V + V - 1 and stores them as one 16-byte run at e P + a0 + c V,
// so that a warp writes 32 / C whole rows of G elements an instruction.
template <typename T, int G>
__global__ void __launch_bounds__(MBT_ROUTE_THREADS)
    bfly_route_kernel(long long P, long long limit,
                      const int* __restrict__ src,
                      const signed char* __restrict__ sub,
                      const signed char* __restrict__ lane,
                      const T* __restrict__ in, T* __restrict__ out) {
  constexpr int WIN = MBT_BFLY_WIN, V = 16 / (int)sizeof(T), C = G / V;
  static_assert(G % V == 0 && G * 4 <= MBT_ROUTE_HEAD - 16, "G");
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);
  int* win = reinterpret_cast<int*>(smem + 16);
  T* xs = reinterpret_cast<T*>(smem + MBT_ROUTE_HEAD);
  signed char* subs = reinterpret_cast<signed char*>(xs + G * WIN);
  signed char* lanes = subs + G * WIN;
  const int tid = threadIdx.x;
  const long long a0 = (long long)blockIdx.x * G;
  const int gw = (int)(P - a0 < G ? P - a0 : G);   // windows of this block
  if (tid < gw) win[tid] = src ? __ldg(src + a0 + tid) : (int)(a0 + tid);
  if (tid == 0) mbar_init(bar);
  __syncthreads();
  if (tid == 0) {
    unsigned bytes = 2u * gw * WIN;
    for (int g = 0; g < gw; ++g)
      bytes += route_copied<T>(limit, win[g]) * (unsigned)sizeof(T);
    mbar_expect(bar, bytes);
    bulk_load(subs, sub + a0 * WIN, gw * WIN, bar);
    bulk_load(lanes, lane + a0 * WIN, gw * WIN, bar);
    for (int g = 0; g < gw; ++g) {
      const int n = route_copied<T>(limit, win[g]);
      if (n) bulk_load(xs + g * WIN, in + (long long)win[g] * WIN,
                       n * (unsigned)sizeof(T), bar);
    }
  }
  // a window that crosses limit: the rest element by element, 0 past it
  for (int g = 0; g < gw; ++g) {
    const long long b = (long long)win[g] * WIN;
    for (int k = route_copied<T>(limit, win[g]) + tid; k < WIN;
         k += MBT_ROUTE_THREADS)
      xs[g * WIN + k] = b + k < limit ? in[b + k] : T(0);
  }
  mbar_wait(bar, 0);
  __syncthreads();
  const bool whole = gw == G && P % V == 0;
  for (int it = tid; it < WIN * C; it += MBT_ROUTE_THREADS) {
    const int e = it / C, g0 = (it % C) * V;
    T v[V];
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int g = g0 + q;
      if (g < gw) {
        const int lam = lanes[g * WIN + e];
        const int s = subs[g * WIN + (e & ~127) + lam];
        v[q] = xs[g * WIN + s * 128 + lam];
      }
    }
    T* d = out + (long long)e * P + a0 + g0;
    if (whole) {
      int4 w;
      memcpy(&w, v, 16);
      __stcs(reinterpret_cast<int4*>(d), w);
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q)
        if (g0 + q < gw) d[q] = v[q];
    }
  }
}

// The decode: k3_col[w, R * 128 + j] for the 16 slots j = 32 q + 4 k + i
// (q, i < 4) of each of a thread's slabs, k = threadIdx.x % 8, so that the
// 8 threads of a slab load and store 128 contiguous bytes an instruction;
// block R is one 128-row tile. Its stack windows of z arrive by one bulk
// copy while the threads load their lane and sublane bytes; the 8 threads
// of a slab share its sublane row through shared memory.
__global__ void __launch_bounds__(MBT_DECODE_THREADS)
    bfly_decode_kernel(long long n_pad, int width, int stack, int rb,
                       const signed char* __restrict__ sub,
                       const signed char* __restrict__ lane,
                       const int* __restrict__ z, int* __restrict__ col) {
  constexpr int SLABS = MBT_DECODE_THREADS / 8;   // slabs a pass
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);
  signed char* subs = reinterpret_cast<signed char*>(smem + 16);
  int* zs = reinterpret_cast<int*>(smem + 16 + SLABS * 128);
  const int tid = threadIdx.x, k4 = (tid % 8) * 4;
  const long long R = blockIdx.x;
  if (tid == 0) mbar_init(bar);
  __syncthreads();
  if (tid == 0) {
    const unsigned bytes = stack * MBT_BFLY_WIN * 4u;
    mbar_expect(bar, bytes);
    bulk_load(zs, z + R * stack * MBT_BFLY_WIN, bytes, bar);
  }
  signed char* srow = subs + (tid / 8) * 128;
  bool staged = false;
  // every thread of a warp makes the same passes (width % 8 == 0)
  for (int w = tid / 8; w < width; w += SLABS) {
    const long long row = (long long)w * n_pad + R * 128;
    int l4[4], s4[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      l4[q] = __ldcs(reinterpret_cast<const int*>(lane + row + 32 * q + k4));
      s4[q] = __ldcs(reinterpret_cast<const int*>(sub + row + 32 * q + k4));
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<int*>(srow + 32 * q + k4) = s4[q];
    __syncwarp();
    if (!staged) {
      mbar_wait(bar, 0);
      staged = true;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      signed char lam[4];
      memcpy(lam, &l4[q], 4);
      int c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = lam[i], s = srow[l], j = 32 * q + k4 + i;
        c[i] = zs[((j / rb) * MBT_BFLY_SUB + (s & 7)) * 128 + l] - 1;
      }
      *reinterpret_cast<int4*>(col + row + 32 * q + k4) =
          make_int4(c[0], c[1], c[2], c[3]);
    }
  }
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

static inline bool aligned16(const void* p) {
  return (uintptr_t)p % 16 == 0;
}

template <typename T>
static cudaError_t launch_route(long long P, long long limit, const int* src,
                                const signed char* sub,
                                const signed char* lane, const T* in, T* out,
                                cudaStream_t stream) {
  constexpr int G = MBT_ROUTE_VECS * 16 / (int)sizeof(T);
  // the windows and their two table rows
  constexpr int smem =
      MBT_ROUTE_HEAD + G * MBT_BFLY_WIN * ((int)sizeof(T) + 2);
  if (P < 1 || limit < 1 || !aligned16(sub) || !aligned16(lane) ||
      !aligned16(in) || !aligned16(out))
    return cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory only by opting in, once
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      bfly_route_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (opt_in != cudaSuccess) return opt_in;
  bfly_route_kernel<T, G><<<(P + G - 1) / G, MBT_ROUTE_THREADS, smem,
                            stream>>>(P, limit, src, sub, lane, in, out);
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
// mid [P * 1024], written transposed (mid[e * P + a]: slot e of window
// a); elements of 4 bytes (b32) or 8 bytes (b64).
cudaError_t mbt_bfly_k1_b32(long long P, long long n_cols, const int* src,
                            const signed char* sub, const signed char* lane,
                            const unsigned int* x, unsigned int* mid,
                            cudaStream_t stream) {
  return launch_route(P, n_cols, src, sub, lane, x, mid, stream);
}

cudaError_t mbt_bfly_k1_b64(long long P, long long n_cols, const int* src,
                            const signed char* sub, const signed char* lane,
                            const unsigned long long* x,
                            unsigned long long* mid, cudaStream_t stream) {
  return launch_route(P, n_cols, src, sub, lane, x, mid, stream);
}

// K2: k2_sub, k2_lane [P, 8, 128] int8; mid, z [P * 1024], z written
// transposed (z[e * P + m]: slot e of window m).
cudaError_t mbt_bfly_k2_b32(long long P, const signed char* sub,
                            const signed char* lane, const unsigned int* mid,
                            unsigned int* z, cudaStream_t stream) {
  return launch_route(P, P * MBT_BFLY_WIN, (const int*)nullptr, sub, lane,
                      mid, z, stream);
}

cudaError_t mbt_bfly_k2_b64(long long P, const signed char* sub,
                            const signed char* lane,
                            const unsigned long long* mid,
                            unsigned long long* z, cudaStream_t stream) {
  return launch_route(P, P * MBT_BFLY_WIN, (const int*)nullptr, sub, lane,
                      mid, z, stream);
}

// The decode: k3_sub, k3_lane [width, n_pad] int8 (the [W//8, 8, NR, 128]
// tables); z [P * 1024] int32, the routed iota; k3_col [width, n_pad].
cudaError_t mbt_bfly_decode(long long n_pad, int width, int stack, int rb,
                            const signed char* sub, const signed char* lane,
                            const int* z, int* col, cudaStream_t stream) {
  if (n_pad < 128 || n_pad % 128 != 0 || width < 8 || width % 8 != 0 ||
      stack < 1 || stack > 8 || rb * stack != 128 || !aligned16(sub) ||
      !aligned16(lane) || !aligned16(z) || !aligned16(col))
    return cudaErrorInvalidValue;
  const int smem =
      16 + MBT_DECODE_THREADS / 8 * 128 + stack * MBT_BFLY_WIN * 4;
  bfly_decode_kernel<<<n_pad / 128, MBT_DECODE_THREADS, smem, stream>>>(
      n_pad, width, stack, rb, sub, lane, z, col);
  return cudaGetLastError();
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
