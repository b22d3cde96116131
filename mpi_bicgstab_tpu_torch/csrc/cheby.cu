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
// chain on it, recomputing the halo rows. On transport_hard(1602112) the
// halo of one step is 27,378 rows on each side (1.4 MB of float32 band):
// no block's shared memory holds it.
//
// Design: the d steps run as tasks (step k, row tile t) of plan.tile
// rows, in place of whole-grid barriers between steps. The host's plan
// (ops/cuda_cheby.chain_plan) takes the largest tile of 1,024, 512 or 256
// rows that still gives every resident block a task at each step. Step 0
// forms x_0, r_0, d_0; step k >= 1 is the k-th band-multiplying update
// (the loop above at k - 1). Task (k, t) may run once step k - 1 is done
// on every tile within plan.reach tiles of t: those hold every column its
// rows read. The same rule covers the ping-pong of d between two buffers:
// (k + 1, t) overwrites d_{k-1}, which only step-k tasks within the reach
// of t read. A persistent grid (cooperative launch: every block resident,
// so a block that waits never blocks the task it waits for) takes tasks
// from a ticket counter in step-major order, ticket k n_tiles + t, so
// every dependency holds a smaller ticket and no wait can deadlock. A
// block publishes (k, t) by a block barrier and a release store of k + 1
// into the tile's flag; a waiting block spins on the flags it needs with
// acquire loads. So a tile starts its next step as soon as its
// neighbours have finished theirs, not when the slowest block of the grid
// has. The last step publishes nothing: no task waits for it. On an H100
// at degree 8 this beat grid-wide barriers with the same band loads; at
// degrees 1 and 2 it loses to them (PERF.md §6).
//
// Loads: the band evict-first (__ldcs): at the main path's n it is larger
// than the 50 MB L2 (83.3 MB in float32) and is read once per step.
// Vectors other blocks wrote (x, r, d) are read with __ldcg, from L2,
// never from a possibly stale L1 line; v is read-only. Inside a task, a
// row issues the loads of MBT_CHAIN_ILP diagonals before their sums. The
// flags and the ticket counter live in a workspace the wrapper zeroes on
// every call (a captured fill in a CUDA graph), so the kernel resets
// nothing and no call depends on how an earlier one ended.
//
// Bound on the H100: memory. The least traffic for the function is the
// band once, v in and x out: 60 B/row in float32 at W = 13, 96.1 MB at
// n = 1,601,613 (0.0287 ms at 3.35 TB/s), twice that in DF. This design
// reads the band d times (0.2027 ms at d = 8 in float32), which is the
// floor it can reach; the arithmetic (2 flops per band entry and step in
// float32, one 18-flop df_fma in DF) is under a tenth of that.
//
// Exactness: every float32 operation is __fadd_rn / __fsub_rn / __fmul_rn,
// never contracted, in the twin's order (dia_spmv_plain accumulates
// acc + vals[w] x from zero, diagonal by diagonal), so the float32 chain
// takes the plain twin's roundings; the DF chain uses df_core.cuh in the
// twin's nesting and equals it bit for bit. The schedule changes no row's
// arithmetic. The coefficients are computed on the host in float64,
// rounded to float32 (DF: split into hi, lo) and travel by value with the
// plan in the kernel's parameter block: no device copy, so a
// preconditioned tol=0 solve captures in a CUDA graph.
#include "df_core.cuh"

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

// The schedule (ops/cuda_cheby.ChainPlan).
struct ChainPlan {
  int tile;      // rows of a task
  int n_tiles;   // ceil(n / tile)
  int reach;     // tiles each side whose previous step a task needs
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Take tickets until none is left; run each task's rows with step(k, t).
// work: [n_tiles] flags (steps done on each tile), then the counter.
// Thread 0 takes the next ticket while the block runs the current task
// (a block holds at most two; every dependency of either still holds a
// smaller ticket). Publishing follows the split-K semaphore pattern: a
// block barrier, then one release store at GPU scope, which covers the
// whole block's writes; waiting is acquire loads, then a block barrier.
template <typename Step>
__device__ __forceinline__ void run_tasks(const ChainPlan& p, int degree,
                                          unsigned* work, Step step) {
  __shared__ unsigned s_ticket[2];
  unsigned* flags = work;
  unsigned* counter = work + p.n_tiles;
  const unsigned tickets = (unsigned)p.n_tiles * (unsigned)degree;
  if (threadIdx.x == 0) s_ticket[0] = atomicAdd(counter, 1u);
  __syncthreads();
  for (int slot = 0;; slot ^= 1) {
    const unsigned tk = s_ticket[slot];
    if (tk >= tickets) return;
    if (threadIdx.x == 0) s_ticket[slot ^ 1] = atomicAdd(counter, 1u);
    const int k = (int)(tk / (unsigned)p.n_tiles);
    const int t = (int)(tk % (unsigned)p.n_tiles);
    if (k > 0) {
      const int lo = max(t - p.reach, 0);
      const int hi = min(t + p.reach, p.n_tiles - 1);
      for (int q = lo + (int)threadIdx.x; q <= hi; q += blockDim.x)
        while (ld_acquire(flags + q) < (unsigned)k) __nanosleep(32);
      __syncthreads();
    }
    step(k, t);
    if (k + 1 < degree) {
      __syncthreads();
      if (threadIdx.x == 0) st_release(flags + t, (unsigned)k + 1u);
    }
    __syncthreads();   // the next ticket is in s_ticket[slot ^ 1]
  }
}

// --- band rows ---------------------------------------------------------

// sum_w vals[w, i] * src(i + off[w]) over the in-range columns, each
// product and sum rounded on its own (the twin's pad-plus-slice order).
// The diagonals go in chunks of MBT_CHAIN_ILP: every load of a chunk is
// issued before its sums, so a row waits about one memory latency per
// chunk, not one per diagonal.
#define MBT_CHAIN_ILP 4
#define MBT_CHAIN_ILP_DF 2
// resident blocks per SM the register budget is held to (40 registers a
// thread)
#define MBT_CHAIN_MIN_BLOCKS 6

template <typename Src>
__device__ __forceinline__ float band_row(const DiaOffsets& offs,
                                          const float* __restrict__ vals,
                                          long long n, long long i,
                                          Src src) {
  float acc = 0.0f;
  for (int w0 = 0; w0 < offs.n_diags; w0 += MBT_CHAIN_ILP) {
    float a[MBT_CHAIN_ILP], x[MBT_CHAIN_ILP];
    bool in[MBT_CHAIN_ILP];
#pragma unroll
    for (int u = 0; u < MBT_CHAIN_ILP; ++u) {
      const int w = w0 + u;
      const long long j = i + (w < offs.n_diags ? offs.off[w] : 0);
      in[u] = w < offs.n_diags && j >= 0 && j < n;
      a[u] = in[u] ? __ldcs(vals + (long long)w * n + i) : 0.0f;
      x[u] = in[u] ? src(j) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < MBT_CHAIN_ILP; ++u)
      if (in[u]) acc = __fadd_rn(acc, __fmul_rn(a[u], x[u]));
  }
  return acc;
}

// dia_row_df's arithmetic (df_core.cuh) in the chain's chunks: an
// out-of-range column contributes df_fma(acc, a, (0, 0)), as in the twin.
template <typename Src>
__device__ __forceinline__ df_t band_row_df(const DiaOffsets& offs,
                                            const float* __restrict__ vh,
                                            const float* __restrict__ vl,
                                            long long n, long long i,
                                            Src src) {
  df_t acc = {0.0f, 0.0f};
  for (int w0 = 0; w0 < offs.n_diags; w0 += MBT_CHAIN_ILP_DF) {
    df_t a[MBT_CHAIN_ILP_DF], x[MBT_CHAIN_ILP_DF];
#pragma unroll
    for (int u = 0; u < MBT_CHAIN_ILP_DF; ++u) {
      const int w = w0 + u;
      const bool real = w < offs.n_diags;
      const long long j = i + (real ? offs.off[w] : 0);
      const long long at = (long long)w * n + i;
      a[u] = real ? df_t{__ldcs(vh + at), __ldcs(vl + at)}
                  : df_t{0.0f, 0.0f};
      x[u] = real && j >= 0 && j < n ? src(j) : df_t{0.0f, 0.0f};
    }
#pragma unroll
    for (int u = 0; u < MBT_CHAIN_ILP_DF; ++u)
      if (w0 + u < offs.n_diags) acc = df_fma(acc, a[u], x[u]);
  }
  return acc;
}

struct ScaledSrc {  // x_0 = v / theta, formed at the band columns
  const float* __restrict__ v;
  float s;
  __device__ __forceinline__ float operator()(long long j) const {
    return __fmul_rn(s, __ldg(v + j));
  }
};

// d_k at the band columns. A vector this launch writes (x, r, d) is read
// after the task's acquire with __ldcg, from L2, never from L1 or the
// non-coherent path, which could hold a line from before another block's
// release.
struct CgSrc {
  const float* d;
  __device__ __forceinline__ float operator()(long long j) const {
    return __ldcg(d + j);
  }
};

struct ScaledSrcDF {  // x_0 = 0 + (1 / theta) v, formed at the band columns
  const float* __restrict__ vh;
  const float* __restrict__ vl;
  df_t s;
  __device__ __forceinline__ df_t operator()(long long j) const {
    return df_fma({0.0f, 0.0f}, s, ld_df(vh, vl, j));
  }
};

struct CgSrcDF {
  const float* h;
  const float* l;
  __device__ __forceinline__ df_t operator()(long long j) const {
    return {__ldcg(h + j), __ldcg(l + j)};
  }
};

// --- float32 -----------------------------------------------------------

struct ChainF32 {
  const DiaOffsets* offs;
  const ChebyCoeffs* c;
  long long n;
  const float* vals;
  const float* v;
  float* x;
  float* r;
  float* d[2];   // d_k lives in d[k & 1]
};

__device__ __forceinline__ void rows_f32(const ChainF32& a, int k,
                                         long long begin, long long end) {
  const ChebyCoeffs& c = *a.c;
  const float it = c.inv_theta;
  if (k == 0) {
    for (long long i = begin + threadIdx.x; i < end; i += blockDim.x) {
      const float vi = __ldg(a.v + i);
      const float ri = __fsub_rn(
          vi, band_row(*a.offs, a.vals, a.n, i, ScaledSrc{a.v, it}));
      const float di = __fmul_rn(it, ri);
      const float xi = __fmul_rn(it, vi);
      if (c.degree == 1) {
        a.x[i] = __fadd_rn(xi, di);
      } else {
        a.x[i] = xi;
        a.r[i] = ri;
        a.d[0][i] = di;
      }
    }
    return;
  }
  // step k: the loop's step k - 1, reading d_{k-1}, writing d_k
  const float cd = c.cd[k - 1];
  const float cr = c.cr[k - 1];
  const bool last = k + 1 == c.degree;
  const float* dc = a.d[(k - 1) & 1];
  float* dn = a.d[k & 1];
  for (long long i = begin + threadIdx.x; i < end; i += blockDim.x) {
    const float di = __ldcg(dc + i);
    const float xi = __fadd_rn(__ldcg(a.x + i), di);
    const float rn = __fsub_rn(
        __ldcg(a.r + i),
        band_row(*a.offs, a.vals, a.n, i, CgSrc{dc}));
    const float dni = __fadd_rn(__fmul_rn(cd, di), __fmul_rn(cr, rn));
    if (last) {
      a.x[i] = __fadd_rn(xi, dni);
    } else {
      a.x[i] = xi;
      a.r[i] = rn;
      dn[i] = dni;
    }
  }
}

__global__ void __launch_bounds__(MBT_BLOCK, MBT_CHAIN_MIN_BLOCKS)
    cheby_f32_kernel(const __grid_constant__ DiaOffsets offs,
                     const __grid_constant__ ChebyCoeffs c,
                     const __grid_constant__ ChainPlan p, long long n,
                     const float* __restrict__ vals,
                     const float* __restrict__ v, float* x, float* r,
                     float* d0, float* d1, unsigned* work) {
  const ChainF32 a = {&offs, &c, n, vals, v, x, r, {d0, d1}};
  run_tasks(p, c.degree, work, [&](int k, int t) {
    const long long begin = (long long)t * p.tile;
    rows_f32(a, k, begin, min(begin + p.tile, n));
  });
}

// --- double-float --------------------------------------------------------

struct ChainDF {
  const DiaOffsets* offs;
  const ChebyCoeffsDF* c;
  long long n;
  const float* valh;
  const float* vall;
  const float* vh;
  const float* vl;
  float* xh;
  float* xl;
  float* rh;
  float* rl;
  float* dh[2];
  float* dl[2];
};

__device__ __forceinline__ void rows_df(const ChainDF& a, int k,
                                        long long begin, long long end) {
  const ChebyCoeffsDF& c = *a.c;
  const df_t zero = {0.0f, 0.0f};
  const df_t one = {1.0f, 0.0f};
  const df_t minus_one = {-1.0f, 0.0f};
  const df_t it = c.inv_theta;
  if (k == 0) {
    for (long long i = begin + threadIdx.x; i < end; i += blockDim.x) {
      const df_t vi = ld_df(a.vh, a.vl, i);
      const df_t ax = band_row_df(*a.offs, a.valh, a.vall, a.n, i,
                                  ScaledSrcDF{a.vh, a.vl, it});
      const df_t ri = df_fma(vi, minus_one, ax);
      const df_t di = df_fma(zero, it, ri);
      const df_t xi = df_fma(zero, it, vi);
      if (c.degree == 1) {
        st_df(a.xh, a.xl, i, df_fma(xi, one, di));
      } else {
        st_df(a.xh, a.xl, i, xi);
        st_df(a.rh, a.rl, i, ri);
        st_df(a.dh[0], a.dl[0], i, di);
      }
    }
    return;
  }
  const df_t cd = c.cd[k - 1];
  const df_t cr = c.cr[k - 1];
  const bool last = k + 1 == c.degree;
  const float* dch = a.dh[(k - 1) & 1];
  const float* dcl = a.dl[(k - 1) & 1];
  float* dnh = a.dh[k & 1];
  float* dnl = a.dl[k & 1];
  for (long long i = begin + threadIdx.x; i < end; i += blockDim.x) {
    const df_t di = {__ldcg(dch + i), __ldcg(dcl + i)};
    const df_t xi = df_fma({__ldcg(a.xh + i), __ldcg(a.xl + i)}, one, di);
    const df_t y = band_row_df(*a.offs, a.valh, a.vall, a.n, i,
                               CgSrcDF{dch, dcl});
    const df_t rn = df_fma({__ldcg(a.rh + i), __ldcg(a.rl + i)}, minus_one,
                           y);
    const df_t dni = df_fma(df_fma(zero, cd, di), cr, rn);
    if (last) {
      st_df(a.xh, a.xl, i, df_fma(xi, one, dni));
    } else {
      st_df(a.xh, a.xl, i, xi);
      st_df(a.rh, a.rl, i, rn);
      st_df(dnh, dnl, i, dni);
    }
  }
}

__global__ void __launch_bounds__(MBT_BLOCK, MBT_CHAIN_MIN_BLOCKS)
    cheby_df_kernel(const __grid_constant__ DiaOffsets offs,
                    const __grid_constant__ ChebyCoeffsDF c,
                    const __grid_constant__ ChainPlan p, long long n,
                    const float* __restrict__ valh,
                    const float* __restrict__ vall,
                    const float* __restrict__ vh,
                    const float* __restrict__ vl, float* xh, float* xl,
                    float* scratch, unsigned* work) {
  // scratch: [6, n] = r (hi, lo), d0 (hi, lo), d1 (hi, lo)
  const ChainDF a = {&offs, &c, n, valh, vall, vh, vl, xh, xl,
                     scratch, scratch + n,
                     {scratch + 2 * n, scratch + 4 * n},
                     {scratch + 3 * n, scratch + 5 * n}};
  run_tasks(p, c.degree, work, [&](int k, int t) {
    const long long begin = (long long)t * p.tile;
    rows_df(a, k, begin, min(begin + p.tile, n));
  });
}

// --- launch ------------------------------------------------------------

// The plan from the host's int32 array (tile, n_tiles, reach), refused
// unless it is safe for these offsets: reach must cover the widest
// in-range offset, or a task could run before one of its dependencies.
static bool mbt_fill_plan(ChainPlan& p, const int* plan, long long n,
                          const DiaOffsets& o, int degree) {
  p.tile = plan[0];
  p.n_tiles = plan[1];
  p.reach = plan[2];
  if (p.tile < 1 || p.n_tiles != (n + p.tile - 1) / p.tile || p.reach < 0)
    return false;
  long long widest = 0;
  for (int w = 0; w < o.n_diags; ++w) {
    const long long a = o.off[w] < 0 ? -(long long)o.off[w] : o.off[w];
    if (a < n && a > widest) widest = a;
  }
  if ((long long)p.reach * p.tile < widest) return false;
  return (double)p.n_tiles * degree < 4.0e9;   // tickets fit 32 bits
}

// The persistent grid: one block a task, capped at what is resident at
// once (a cooperative launch refuses more).
template <typename Kernel>
static cudaError_t coop_grid(Kernel kernel, long long want, int* grid) {
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
  const long long have = (long long)per_sm * sms;
  *grid = (int)(want < have ? want : have);
  return cudaSuccess;
}

extern "C" {

// The chain kernels' registers and resident blocks per SM (df: 0 for
// float32, 1 for DF), and the card's SM count.
cudaError_t mbt_cheby_kernel_info(int df, int* regs, int* blocks_per_sm,
                                  int* sms) {
  cudaFuncAttributes attr;
  const void* k = df ? (const void*)cheby_df_kernel
                     : (const void*)cheby_f32_kernel;
  cudaError_t err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, k,
                                                      MBT_BLOCK, 0);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// coeffs (host): inv_theta, then (c_d, c_r) per step; plan (host): the
// three ints of mbt_fill_plan; scratch: [3, n] = r, d0, d1 (float32); work:
// [n_tiles + 1] zeroed int32 (flags, counter); x: the [n] result.
cudaError_t mbt_cheby_chain_f32(const int* offsets, int n_diags, long long n,
                                const float* vals, const float* v,
                                const float* coeffs, int degree,
                                const int* plan, float* x, float* scratch,
                                unsigned* work, cudaStream_t stream) {
  DiaOffsets o;
  ChainPlan p;
  if (n < 1 || degree < 1 || degree > MBT_MAX_CHEBY_DEGREE ||
      !mbt_fill_offsets(o, offsets, n_diags) ||
      !mbt_fill_plan(p, plan, n, o, degree))
    return cudaErrorInvalidValue;
  ChebyCoeffs c;
  c.degree = degree;
  c.inv_theta = coeffs[0];
  for (int k = 0; k < degree; ++k) {
    c.cd[k] = coeffs[1 + 2 * k];
    c.cr[k] = coeffs[2 + 2 * k];
  }
  int grid = 0;
  cudaError_t err =
      coop_grid(cheby_f32_kernel, (long long)p.n_tiles * degree, &grid);
  if (err != cudaSuccess) return err;
  float* r = scratch;
  float* d0 = scratch + n;
  float* d1 = scratch + 2 * n;
  void* args[] = {&o, &c, &p, &n, &vals, &v, &x, &r, &d0, &d1, &work};
  err = cudaLaunchCooperativeKernel((const void*)cheby_f32_kernel, grid,
                                    MBT_BLOCK, args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// coeffs (host): (hi, lo) of inv_theta, then of c_d and c_r per step;
// plan, work: as for float32; scratch: [6, n] (r, d0, d1 as hi, lo rows);
// xh, xl: the [n] result.
cudaError_t mbt_cheby_chain_df(const int* offsets, int n_diags, long long n,
                               const float* valh, const float* vall,
                               const float* vh, const float* vl,
                               const float* coeffs, int degree,
                               const int* plan, float* xh, float* xl,
                               float* scratch, unsigned* work,
                               cudaStream_t stream) {
  DiaOffsets o;
  ChainPlan p;
  if (n < 1 || degree < 1 || degree > MBT_MAX_CHEBY_DEGREE ||
      !mbt_fill_offsets(o, offsets, n_diags) ||
      !mbt_fill_plan(p, plan, n, o, degree))
    return cudaErrorInvalidValue;
  ChebyCoeffsDF c;
  c.degree = degree;
  c.inv_theta = {coeffs[0], coeffs[1]};
  for (int k = 0; k < degree; ++k) {
    c.cd[k] = {coeffs[2 + 4 * k], coeffs[3 + 4 * k]};
    c.cr[k] = {coeffs[4 + 4 * k], coeffs[5 + 4 * k]};
  }
  int grid = 0;
  cudaError_t err =
      coop_grid(cheby_df_kernel, (long long)p.n_tiles * degree, &grid);
  if (err != cudaSuccess) return err;
  void* args[] = {&o,  &c,  &p,  &n,  &valh,    &vall,
                  &vh, &vl, &xh, &xl, &scratch, &work};
  err = cudaLaunchCooperativeKernel((const void*)cheby_df_kernel, grid,
                                    MBT_BLOCK, args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
