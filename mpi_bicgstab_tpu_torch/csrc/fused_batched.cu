// The three passes of one fused batched classic-BiCGStab iteration over
// k <= 8 right-hand-side lanes, float32 (the passes of fused_classic.cu,
// lane by lane; reference solver.c:86-119 per lane, the end-of-loop p
// update deferred into the next iteration's K1):
//
//   K1b: p'_l = r_l + beta_l (p_l - omega_l s_l)   stage 0: once a row
//        s'_l = A p'_l                              stage 1: from stored p'
//        partial (r^_l, s'_l)
//   K2b: q_l  = r_l - alpha_l s'_l                  stage 0: once a row
//        y_l  = A q_l                               stage 1: from stored q
//        partials (q_l, y_l), (y_l, y_l)
//   K3b: x'_l = x_l + alpha_l p'_l + omega_l q_l    pointwise
//        r'_l = q_l - omega_l y_l
//        partials (r'_l, r'_l), (r^_l, r'_l)
//
// Replaces: mpi_bicgstab_tpu/ops/pallas_fused_batched.py::_k1_kernel,
// ::_k2_kernel and ::_k3_kernel (wrappers fused_k1b / fused_k2b /
// fused_k3b). Those DMA a chunk window of every lane into VMEM, form p'
// (or q) once on the window and multiply from it, with a stash for the
// rows the next chunk still needs.
//
// Design: K1b and K2b run as two launches a pass. Stage 0 is pointwise:
// it forms p' (or q) once per row and lane and stores it in the pass's
// output plane P2 (or Q), which the pass must write anyway. Stage 1 is
// the lanes SpMV of batched_core.cuh over the stored plane: each thread
// owns one row of every lane and reads its W neighbours' values, never
// recomputing them. The launch boundary orders the stages, so stage 1
// reads the plane through the read-only path. No shared-memory halo:
// on transport_like(1602112) a row reaches 13,807 rows each side, and
// one plane's halo (27,614 rows x 8 lanes x 4 B, 884 KB) is four times
// an SM's 228 KB.
//
// Frozen lanes (active_l == 0) keep their old values bit for bit: P2 = p
// and S2 = s in K1b, x' = x and r' = q in K3b. Their dots are those of
// the unmasked values, as in JAX (the solver loop discards them), so
// K1b still needs a frozen lane's unmasked p', whose beta and omega may
// be NaN or inf: stage 0 writes it to the scratch plane u and p to P2,
// and stage 1 takes a frozen lane's neighbours from u. Writing p over a
// p' that other rows still read would be a race. K2b takes no flag: the
// solver loop runs frozen lanes with alpha = 0, so q = r exactly.
//
// Bound on the H100: memory. At n = 1,602,112, W = 15, k = 8 one [8, n]
// plane is 51.3 MB and the band 96.1 MB; each input once and each output
// once: K1b 403.7 MB (120.5 us at 3.35 TB/s), K2b 301.2 MB (89.9 us),
// K3b 358.9 MB (107.1 us). This design reads the stored plane once more
// (its floor: K1b 135.8 us, K2b 105.2 us). Stage 1's neighbour reads
// come from L1 and L2, not HBM.
//
// Dots: each block writes one [D, k] row of per-lane partials (lane l's
// d-th partial at d * k + l), and mbt_finish adds the rows in a fixed
// order: no float atomics. The per-lane scalars are [k] device arrays
// read through pointers. Stage 0 forms p' and q with explicit
// single-rounding FMAs, so the stored values do not depend on the
// compiler's contraction choices.
//
// The halo form (the row-partitioned batch, solvers/batched_dist.py):
// every plane is [k, ld] with ld = n + 2h, lane l's row j at l * ld + j
// from pointers at the rank's first row, and h rows of each neighbour on
// either side. Stage 0 forms p' (or q) over the rows [lo, hi), the halo
// rows included, from inputs whose edges were exchanged before the pass
// (the scratch plane u too, for a frozen lane's neighbours); stage 1 and
// K3b run over the rank's n rows, stage 1 reading the columns [lo, hi).
// lo is -h where a previous rank exists, hi n + h where a next one does.
// The halo is a template flag: the [0, n) instance (lo 0, hi n, ld n) is
// the kernel of one device.
//
// Each launcher runs its pass and the partial-sum stage on `stream` and
// returns cudaGetLastError().
#include "batched_core.cuh"

// The stored planes stage 1 multiplies from (written by stage 0's
// launch, read-only in this one).
template <int K>
struct StoredLanes {
  const float* base[K];   // lane l's plane, row 0
  __device__ __forceinline__ float operator()(int l, long long j) const {
    return __ldg(base[l] + j);
  }
};

struct K1bArgs {
  long long n, lo, hi, ld;  // rows, readable columns, lane stride
  const float* vals;
  const float* r;
  const float* p;
  const float* s;
  const float* r_hat;
  const float* beta;
  const float* omega;
  const float* active;
  float* p2;
  float* s2;
  float* u;          // a plane of scratch: a frozen lane's unmasked p'
  float* partials;
};

struct K2bArgs {
  long long n, lo, hi, ld;
  const float* vals;
  const float* r;
  const float* s2;
  const float* alpha;
  float* q;
  float* y;
  float* partials;
};

// A pass's rows, readable columns and lane stride: the launch's, or the
// one-device constants when kHalo is false.
struct Geom {
  long long n, lo, hi, ld;
};

template <bool kHalo, typename Args>
__device__ __forceinline__ Geom geom(const Args& a) {
  if (!kHalo) return Geom{a.n, 0, a.n, a.n};
  return Geom{a.n, a.lo, a.hi, a.ld};
}

template <int K>
struct K1bLanes {
  float beta[K], omega[K];
  bool act[K];
  __device__ __forceinline__ explicit K1bLanes(const K1bArgs& a) {
#pragma unroll
    for (int l = 0; l < K; ++l) {
      beta[l] = a.beta[l];
      omega[l] = a.omega[l];
      act[l] = a.active[l] != 0.0f;
    }
  }
};

// K1b stage 0 on row i: p' = r + beta (p - omega s) in one nested FMA
// chain; P2 gets p' on an active lane, p on a frozen one, whose unmasked
// p' goes to the scratch plane u (stage 1 still needs it for the dot).
template <int K>
__device__ __forceinline__ void k1b_form(const K1bArgs& a, const Geom& g,
                                         const K1bLanes<K>& c, long long i) {
  if (i >= g.hi) return;
#pragma unroll
  for (int l = 0; l < K; ++l) {
    const long long o = (long long)l * g.ld + i;
    const float p_o = __ldg(a.p + o);
    const float pp = __fmaf_rn(
        c.beta[l], __fmaf_rn(-c.omega[l], __ldg(a.s + o), p_o),
        __ldg(a.r + o));
    if (c.act[l]) {
      a.p2[o] = pp;
    } else {
      a.p2[o] = p_o;
      a.u[o] = pp;
    }
  }
}

// K1b stage 1 on the 256-row block starting at row0: s' = A p' from the
// stored planes (a frozen lane's from u), S2 (s on a frozen lane), and
// the block's partial row.
template <int K>
__device__ __forceinline__ void k1b_spmv(const DiaOffsets& offs,
                                         const K1bArgs& a, const Geom& g,
                                         const K1bLanes<K>& c,
                                         long long row0, float* out) {
  const long long n = g.n;
  const long long i = row0 + threadIdx.x;
  StoredLanes<K> src;
#pragma unroll
  for (int l = 0; l < K; ++l)
    src.base[l] = (c.act[l] ? a.p2 : a.u) + (long long)l * g.ld;
  float part[K];
#pragma unroll
  for (int l = 0; l < K; ++l) part[l] = 0.0f;
  if (i < n) {
    float acc[K];
    dia_row_lanes<K>(offs, a.vals, n, i, g.lo, g.hi, src, acc);
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const long long o = (long long)l * g.ld + i;
      if (c.act[l])
        a.s2[o] = acc[l];
      else
        a.s2[o] = a.s[o];
      part[l] = a.r_hat[o] * acc[l];
    }
  }
  block_sum<K>(part, out);
}

// K2b stage 0 on row i: q = r - alpha s' (no mask: a frozen lane runs with
// alpha = 0, so q = r).
template <int K>
__device__ __forceinline__ void k2b_form(const K2bArgs& a, const Geom& g,
                                         const float (&alpha)[K],
                                         long long i) {
  if (i >= g.hi) return;
#pragma unroll
  for (int l = 0; l < K; ++l) {
    const long long o = (long long)l * g.ld + i;
    a.q[o] = __fmaf_rn(-alpha[l], __ldg(a.s2 + o), __ldg(a.r + o));
  }
}

// K2b stage 1 on the 256-row block starting at row0: y = A q from the
// stored Q, and the block's partial rows (q, y), (y, y).
template <int K>
__device__ __forceinline__ void k2b_spmv(const DiaOffsets& offs,
                                         const K2bArgs& a, const Geom& g,
                                         long long row0, float* out) {
  const long long n = g.n;
  const long long i = row0 + threadIdx.x;
  StoredLanes<K> src;
#pragma unroll
  for (int l = 0; l < K; ++l) src.base[l] = a.q + (long long)l * g.ld;
  float part[2 * K];
#pragma unroll
  for (int d = 0; d < 2 * K; ++d) part[d] = 0.0f;
  if (i < n) {
    float acc[K];
    dia_row_lanes<K>(offs, a.vals, n, i, g.lo, g.hi, src, acc);
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const long long o = (long long)l * g.ld + i;
      const float q_i = __ldg(a.q + o);
      a.y[o] = acc[l];
      part[l] = q_i * acc[l];
      part[K + l] = acc[l] * acc[l];
    }
  }
  block_sum<2 * K>(part, out);
}

// The four kernels. On an H100 stage 1 ran 3-6% faster at the 40
// registers a thread this code takes (6 blocks an SM) than at 32 (8
// blocks): the loads a thread keeps in flight count, not occupancy.
// Stage 0 runs over the rows [lo, hi): block b starts at row lo + 256 b.
template <int K, bool kHalo>
__global__ void __launch_bounds__(MBT_BLOCK) k1b_form_kernel(
    const __grid_constant__ K1bArgs a) {
  const Geom g = geom<kHalo>(a);
  const K1bLanes<K> c(a);
  k1b_form<K>(a, g, c,
              g.lo + (long long)blockIdx.x * blockDim.x + threadIdx.x);
}

template <int K, bool kHalo>
__global__ void __launch_bounds__(MBT_BLOCK) k1b_spmv_kernel(
    const __grid_constant__ DiaOffsets offs,
    const __grid_constant__ K1bArgs a) {
  const Geom g = geom<kHalo>(a);
  const K1bLanes<K> c(a);
  k1b_spmv<K>(offs, a, g, c, (long long)blockIdx.x * MBT_BLOCK,
              a.partials + (long long)K * blockIdx.x);
}

template <int K, bool kHalo>
__global__ void __launch_bounds__(MBT_BLOCK) k2b_form_kernel(
    const __grid_constant__ K2bArgs a) {
  const Geom g = geom<kHalo>(a);
  float alpha[K];
#pragma unroll
  for (int l = 0; l < K; ++l) alpha[l] = a.alpha[l];
  k2b_form<K>(a, g, alpha,
              g.lo + (long long)blockIdx.x * blockDim.x + threadIdx.x);
}

template <int K, bool kHalo>
__global__ void __launch_bounds__(MBT_BLOCK) k2b_spmv_kernel(
    const __grid_constant__ DiaOffsets offs,
    const __grid_constant__ K2bArgs a) {
  const Geom g = geom<kHalo>(a);
  k2b_spmv<K>(offs, a, g, (long long)blockIdx.x * MBT_BLOCK,
              a.partials + 2LL * K * blockIdx.x);
}

// --- K3b ---------------------------------------------------------------------

template <int K, bool kHalo>
__global__ void __launch_bounds__(MBT_BLOCK)
    k3b_kernel(long long n, long long ld, const float* __restrict__ x,
               const float* __restrict__ p2, const float* __restrict__ q,
               const float* __restrict__ y, const float* __restrict__ r_hat,
               const float* __restrict__ alpha,
               const float* __restrict__ omega,
               const float* __restrict__ active, float* __restrict__ x2,
               float* __restrict__ r2, float* __restrict__ partials) {
  if (!kHalo) ld = n;  // one device: the plain kernel's stride
  float a[K], w[K];
  bool act[K];
#pragma unroll
  for (int l = 0; l < K; ++l) {
    a[l] = alpha[l];
    w[l] = omega[l];
    act[l] = active[l] != 0.0f;
  }
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float part[2 * K];
#pragma unroll
  for (int d = 0; d < 2 * K; ++d) part[d] = 0.0f;
  if (i < n) {
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const long long o = (long long)l * ld + i;
      const float x_i = x[o];
      const float q_i = q[o];
      const float r2_i = __fmaf_rn(-w[l], y[o], q_i);
      const float x2_i = __fmaf_rn(w[l], q_i, __fmaf_rn(a[l], p2[o], x_i));
      x2[o] = act[l] ? x2_i : x_i;
      r2[o] = act[l] ? r2_i : q_i;
      part[l] = r2_i * r2_i;
      part[K + l] = r_hat[o] * r2_i;
    }
  }
  block_sum<2 * K>(part, partials + 2LL * K * blockIdx.x);
}

// --- launchers ---------------------------------------------------------------

template <int K, bool kHalo>
static cudaError_t launch_k1b(const DiaOffsets& o, const K1bArgs& a,
                              float* dots, cudaStream_t stream) {
  const long long G = mbt_grid(a.n);
  k1b_form_kernel<K, kHalo><<<mbt_grid(a.hi - a.lo), MBT_BLOCK, 0,
                              stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k1b_spmv_kernel<K, kHalo><<<G, MBT_BLOCK, 0, stream>>>(o, a);
  return mbt_finish<K>(a.partials, G, dots, stream);
}

template <int K, bool kHalo>
static cudaError_t launch_k2b(const DiaOffsets& o, const K2bArgs& a,
                              float* dots, cudaStream_t stream) {
  const long long G = mbt_grid(a.n);
  k2b_form_kernel<K, kHalo><<<mbt_grid(a.hi - a.lo), MBT_BLOCK, 0,
                              stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k2b_spmv_kernel<K, kHalo><<<G, MBT_BLOCK, 0, stream>>>(o, a);
  return mbt_finish<2 * K>(a.partials, G, dots, stream);
}

template <int K, bool kHalo>
static cudaError_t launch_k3b(long long n, long long ld, const float* x,
                              const float* p2,
                              const float* q, const float* y,
                              const float* r_hat, const float* alpha,
                              const float* omega, const float* active,
                              float* x2, float* r2, float* partials,
                              float* dots, cudaStream_t stream) {
  const long long G = mbt_grid(n);
  k3b_kernel<K, kHalo><<<G, MBT_BLOCK, 0, stream>>>(
      n, ld, x, p2, q, y, r_hat, alpha, omega, active, x2, r2, partials);
  return mbt_finish<2 * K>(partials, G, dots, stream);
}

extern "C" {

// Planes [k, ld] from the rank's first row, rows [lo, hi) formed in
// stage 0 and columns [lo, hi) read in stage 1 (0, n, n on one device);
// beta, omega, active [k]; u a plane of scratch; partials
// [mbt_grid(n), k] scratch; dots [k] = (r^_l, s'_l).
cudaError_t mbt_fused_k1b_f32(const int* offsets, int n_diags, long long n,
                              long long lo, long long hi, long long ld,
                              int k, const float* vals, const float* r,
                              const float* p, const float* s,
                              const float* r_hat, const float* beta,
                              const float* omega, const float* active,
                              float* p2, float* s2, float* u,
                              float* partials, float* dots,
                              cudaStream_t stream) {
  DiaOffsets o;
  if (n < 1 || !mbt_lanes_ok(n, lo, hi, ld) ||
      !mbt_fill_offsets(o, offsets, n_diags))
    return cudaErrorInvalidValue;
  const K1bArgs a{n,    lo,    hi,    ld, vals, r,  p,  s,
                  r_hat, beta, omega, active, p2, s2, u, partials};
  MBT_BY_LANES_HALO(k, mbt_lanes_halo(n, lo, hi, ld),
                    (launch_k1b<K, kHalo>(o, a, dots, stream)));
}

// Planes, bounds and stride as for K1b; alpha [k]; partials
// [mbt_grid(n), 2 k] scratch; dots [2, k] = (q_l, y_l), (y_l, y_l).
cudaError_t mbt_fused_k2b_f32(const int* offsets, int n_diags, long long n,
                              long long lo, long long hi, long long ld,
                              int k, const float* vals, const float* r,
                              const float* s2, const float* alpha, float* q,
                              float* y, float* partials, float* dots,
                              cudaStream_t stream) {
  DiaOffsets o;
  if (n < 1 || !mbt_lanes_ok(n, lo, hi, ld) ||
      !mbt_fill_offsets(o, offsets, n_diags))
    return cudaErrorInvalidValue;
  const K2bArgs a{n, lo, hi, ld, vals, r, s2, alpha, q, y, partials};
  MBT_BY_LANES_HALO(k, mbt_lanes_halo(n, lo, hi, ld),
                    (launch_k2b<K, kHalo>(o, a, dots, stream)));
}

// Planes [k, ld] from the rank's first row, its n rows computed (ld = n
// on one device); alpha, omega, active [k]; partials [mbt_grid(n), 2 k]
// scratch; dots [2, k] = (r'_l, r'_l), (r^_l, r'_l).
cudaError_t mbt_fused_k3b_f32(long long n, long long ld, int k,
                              const float* x,
                              const float* p2, const float* q,
                              const float* y, const float* r_hat,
                              const float* alpha, const float* omega,
                              const float* active, float* x2, float* r2,
                              float* partials, float* dots,
                              cudaStream_t stream) {
  if (n < 1 || ld < n) return cudaErrorInvalidValue;
  MBT_BY_LANES_HALO(k, ld != n,
                    (launch_k3b<K, kHalo>(n, ld, x, p2, q, y, r_hat, alpha,
                                          omega, active, x2, r2, partials,
                                          dots, stream)));
}

}  // extern "C"
