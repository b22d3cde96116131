// Fused double-float (DF) shift update of the seed-switching solver:
// one pass over the [S, n] x_set / p_set state, in place,
//
//   x'    = x + df_fma(cxp p, cxq, q)              (ssw:437-438)
//   p_mid = p + df_fma(cpq q, cpr, r_old)          (ssw:439-440)
//   p'    = df_fma(m1 p_mid, m2, r_new)            (ssw:443-444)
//
// with six DF [S] coefficients into which the caller has folded the
// active mask (stopped and seed rows: 0, 0, 0, 0, 1, 0, exact identities
// for normalised pairs, so frozen rows pass through bit-unchanged).
//
// Replaces: mpi_bicgstab_tpu/ops/pallas_shift_update.py::_kernel (wrapper
// fused_shift_update_df), the TPU kernel that streams (S, nt) lane tiles
// of the state through VMEM with lane-replicated [6, S, 128] coefficients
// and aliases its outputs onto its inputs. None of its TPU gates carry
// over: any S and n are taken (S % 8, n % 128 and the VMEM budget
// _pick_nt exist for the TPU's tiles), the coefficients are read as the
// six DF [S] vectors they are, and the ragged edge is masked here.
//
// Bound on the H100: bytes. The pass reads and writes the four float
// planes of x_set and p_set once: 4 x 8 S n bytes, 26.25 GB at S = 512,
// n = 1,602,112 (7.836 ms at 3.35 TB/s), plus 38 MB of q, r_old and
// r_new. Its arithmetic is ~120 float operations per (row, column) (three
// df_fma, three df_mul, two df_add), ~1.5 ms at 67 TFLOP/s.
//
// Design: each thread owns VEC consecutive columns (VEC = 4, 16-byte
// loads and stores of each plane, when n % 4 == 0 and every pointer is
// 16-byte aligned; else VEC = 1), loads q, r_old and r_new for them once
// and walks a group of ROWS shift rows, whose coefficients sit in shared
// memory. The shared vectors are read S / ROWS times instead of S times;
// the state streams past the L2 evict-first (__ldcs / __stcs), since it
// is read once and written once. Each element is read, then written, by
// the same thread, so the update in place is race-free. The arithmetic is
// df_core.cuh's, in the plain twin's order (ops/cuda_shift_update.py,
// ops/precision.py), so the kernel's bits are the twin's.
#include "df_core.cuh"

#define SU_ROWS 32    // shift rows per block
#define SU_BLOCK 256  // threads per block

// The six DF [S] coefficients: hi, lo of cxp, cxq, cpq, cpr, m1, m2.
struct Coefs {
  const float* p[12];
};

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static void get(const T& v, float (&o)[1]) { o[0] = v; }
  __device__ static T make(const float (&o)[1]) { return o[0]; }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static void get(const T& v, float (&o)[4]) {
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
  __device__ static T make(const float (&o)[4]) {
    return make_float4(o[0], o[1], o[2], o[3]);
  }
};

template <int VEC>
__device__ __forceinline__ void load_shared(const float* __restrict__ a,
                                            long long g, float (&o)[VEC]) {
  Vec<VEC>::get(__ldg(reinterpret_cast<const typename Vec<VEC>::T*>(a) + g),
                o);
}

template <int VEC>
__device__ __forceinline__ void load_state(const float* a, long long g,
                                           float (&o)[VEC]) {
  Vec<VEC>::get(__ldcs(reinterpret_cast<const typename Vec<VEC>::T*>(a) + g),
                o);
}

template <int VEC>
__device__ __forceinline__ void store_state(float* a, long long g,
                                            const float (&o)[VEC]) {
  __stcs(reinterpret_cast<typename Vec<VEC>::T*>(a) + g, Vec<VEC>::make(o));
}

// Grid: x over groups of VEC columns, y over groups of SU_ROWS rows.
template <int VEC>
__global__ void __launch_bounds__(SU_BLOCK)
    shift_update_df_kernel(long long S, long long n_groups,
                           float* __restrict__ xh, float* __restrict__ xl,
                           float* __restrict__ ph, float* __restrict__ pl,
                           const float* __restrict__ qh,
                           const float* __restrict__ ql,
                           const float* __restrict__ roh,
                           const float* __restrict__ rol,
                           const float* __restrict__ rnh,
                           const float* __restrict__ rnl,
                           const __grid_constant__ Coefs cf) {
  __shared__ float coef[12][SU_ROWS];
  const long long row0 = (long long)blockIdx.y * SU_ROWS;
  for (int t = threadIdx.x; t < 12 * SU_ROWS; t += blockDim.x) {
    const int k = t / SU_ROWS, j = t % SU_ROWS;
    coef[k][j] = row0 + j < S ? cf.p[k][row0 + j] : 0.0f;
  }
  __syncthreads();
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_groups) return;

  float a[VEC], b[VEC];
  df_t q[VEC], ro[VEC], rn[VEC];
  load_shared<VEC>(qh, g, a);
  load_shared<VEC>(ql, g, b);
#pragma unroll
  for (int c = 0; c < VEC; ++c) q[c] = {a[c], b[c]};
  load_shared<VEC>(roh, g, a);
  load_shared<VEC>(rol, g, b);
#pragma unroll
  for (int c = 0; c < VEC; ++c) ro[c] = {a[c], b[c]};
  load_shared<VEC>(rnh, g, a);
  load_shared<VEC>(rnl, g, b);
#pragma unroll
  for (int c = 0; c < VEC; ++c) rn[c] = {a[c], b[c]};

  const int rows = (int)min((long long)SU_ROWS, S - row0);
  for (int j = 0; j < rows; ++j) {
    const df_t cxp = {coef[0][j], coef[1][j]};
    const df_t cxq = {coef[2][j], coef[3][j]};
    const df_t cpq = {coef[4][j], coef[5][j]};
    const df_t cpr = {coef[6][j], coef[7][j]};
    const df_t m1 = {coef[8][j], coef[9][j]};
    const df_t m2 = {coef[10][j], coef[11][j]};
    const long long at = (row0 + j) * n_groups + g;  // in units of VEC
    float x_h[VEC], x_l[VEC], p_h[VEC], p_l[VEC];
    load_state<VEC>(xh, at, x_h);
    load_state<VEC>(xl, at, x_l);
    load_state<VEC>(ph, at, p_h);
    load_state<VEC>(pl, at, p_l);
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      const df_t x = {x_h[c], x_l[c]};
      const df_t p = {p_h[c], p_l[c]};
      const df_t x2 = df_add(x, df_fma(df_mul(cxp, p), cxq, q[c]));
      const df_t pm = df_add(p, df_fma(df_mul(cpq, q[c]), cpr, ro[c]));
      const df_t p2 = df_fma(df_mul(m1, pm), m2, rn[c]);
      x_h[c] = x2.hi;
      x_l[c] = x2.lo;
      p_h[c] = p2.hi;
      p_l[c] = p2.lo;
    }
    store_state<VEC>(xh, at, x_h);
    store_state<VEC>(xl, at, x_l);
    store_state<VEC>(ph, at, p_h);
    store_state<VEC>(pl, at, p_l);
  }
}

template <int VEC>
static cudaError_t launch(long long S, long long n, float* xh, float* xl,
                          float* ph, float* pl, const float* qh,
                          const float* ql, const float* roh,
                          const float* rol, const float* rnh,
                          const float* rnl, const Coefs& cf,
                          cudaStream_t stream) {
  const long long n_groups = n / VEC;
  const dim3 grid((unsigned)((n_groups + SU_BLOCK - 1) / SU_BLOCK),
                  (unsigned)((S + SU_ROWS - 1) / SU_ROWS));
  shift_update_df_kernel<VEC><<<grid, SU_BLOCK, 0, stream>>>(
      S, n_groups, xh, xl, ph, pl, qh, ql, roh, rol, rnh, rnl, cf);
  return cudaGetLastError();
}

static bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ULL) == 0;
}

extern "C" {

// x_set, p_set: (hi, lo) planes of [S, n], updated in place; q, r_old,
// r_new: (hi, lo) of [n]; coefs: the 12 pointers of Coefs, each [S].
cudaError_t mbt_shift_update_df(long long S, long long n, float* xh,
                                float* xl, float* ph, float* pl,
                                const float* qh, const float* ql,
                                const float* roh, const float* rol,
                                const float* rnh, const float* rnl,
                                const float* const* coefs,
                                cudaStream_t stream) {
  if (S < 1 || n < 1 || S > 65535LL * SU_ROWS) return cudaErrorInvalidValue;
  Coefs cf;
  for (int k = 0; k < 12; ++k) cf.p[k] = coefs[k];
  const void* ptrs[10] = {xh, xl, ph, pl, qh, ql, roh, rol, rnh, rnl};
  bool vec4 = n % 4 == 0;
  for (const void* p : ptrs) vec4 = vec4 && aligned16(p);
  if (vec4)
    return launch<4>(S, n, xh, xl, ph, pl, qh, ql, roh, rol, rnh, rnl, cf,
                     stream);
  return launch<1>(S, n, xh, xl, ph, pl, qh, ql, roh, rol, rnh, rnl, cf,
                   stream);
}

}  // extern "C"
