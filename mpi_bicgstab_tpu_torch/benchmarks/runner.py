"""SpMV and solver-iteration timing on the card (counterpart of
mpi_bicgstab_tpu/benchmarks/runner.py: `_slope_time`, `bench_spmv`,
`bench_iteration`, `bench_batched_iteration`, `bench_shifted_iteration`,
and `bench_cheby`, the `--what cheby` section of its run_bench).

Every time is a slope: the timed operation runs as a chain of K1 and of
K2 back-to-back calls on the current stream, each chain timed with CUDA
events, and cost per call = (t(K2) - t(K1)) / (K2 - K1), so the fixed
cost of a chain (the solver's r0 and true-residual SpMVs, the first
launch's latency) cancels. The result is the median of several slopes.
The events measure stream time, which includes any gap the host leaves
between launches: a host-bound loop shows as such. time_call(graph=True)
captures each chain in a CUDA graph first, so that the replay measures
the device's own time for the launches with no host in between. There
is no CPU path: without a card these functions raise.
"""
from __future__ import annotations

import numpy as np
import torch


def _require_cuda():
    if not torch.cuda.is_available():
        raise RuntimeError("timing needs a CUDA device; there is none")


def _chain_seconds(chain) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    chain()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _slope_time(make_chain, K1=10, K2=60, reps=5) -> float:
    """Seconds per operation: median over `reps` of the slope between a
    K1-long and a K2-long chain (make_chain(K) returns a callable that
    runs K operations)."""
    _require_cuda()
    c1, c2 = make_chain(K1), make_chain(K2)
    c1()
    c2()
    torch.cuda.synchronize()
    slopes = []
    for _ in range(reps):
        t1 = _chain_seconds(c1)
        t2 = _chain_seconds(c2)
        slopes.append((t2 - t1) / (K2 - K1))
    return float(np.median(slopes))


def _graph(chain):
    """chain captured in a CUDA graph (after one warm-up run on a side
    stream, which initialises library handles outside the capture)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        chain()
    return g.replay


def time_call(fn, iters=60, reps=5, graph=False) -> float:
    """Seconds per call of fn() (any launches on the current stream):
    with graph=False as the host issues them, with graph=True the
    device's time alone (the chains are replayed CUDA graphs)."""
    def make_chain(K):
        def chain():
            for _ in range(K):
                fn()
        return _graph(chain) if graph else chain
    return _slope_time(make_chain, K1=max(2, iters // 6), K2=iters,
                       reps=reps)


def bench_spmv(prob, iters=60, seed=0) -> dict:
    """SpMV time and rate of prob.A on a random x (layout.spmv, so the
    DIA kernel for a DiaMatrix on the card). Rate = nnz of the host CSR
    per second, as the JAX bench reports it; the windowed-ELL and
    butterfly layouts add their padded widths (and the butterfly its
    window count P)."""
    from mpi_bicgstab_tpu_torch.ops.layout import spmv
    x = torch.as_tensor(np.random.default_rng(seed).standard_normal(prob.n),
                        dtype=prob.b.dtype, device=prob.b.device)
    sec = time_call(lambda: spmv(prob.A, x), iters=iters)
    out = {"spmv_s": sec, "spmv_nnz_per_s": prob.csr.nnz / sec,
           "spmv_layout": type(prob.A).__name__}
    if out["spmv_layout"] == "WindowEllMatrix":
        # the built layout's slab count (vals is [W, T, 8, 128]): the
        # padded width the byte count needs, as the JAX bench reports it
        out["spmv_window_width"] = int(prob.A.width)
    elif out["spmv_layout"] == "ButterflyMatrix":
        # the routed layout's window count and K3 slab count, which its
        # stages' bytes follow
        out["spmv_butterfly_P"] = int(prob.A.P)
        out["spmv_butterfly_width"] = int(prob.A.width)
    return out


def bench_iteration(prob, method="bicgstab", iters=60, reps=3,
                    graph=False, precond=None) -> dict:
    """Time per solver iteration: solves with tol=0 (exactly max_iter
    iterations, no host synchronisation at all) at two max_iter, and the
    slope between them — the avg time/iter the reference prints
    (solver.c:139). With graph=True each solve is captured in a CUDA
    graph and replayed: the device's own time per iteration, every
    kernel of the loop included and the host's gaps left out. precond:
    a ChebyPrecond with its bounds set (the exit transform is a fixed
    cost per solve, so the slope leaves it out)."""
    from mpi_bicgstab_tpu_torch.api import solve
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig

    def make_chain(K):
        cfg = SolverConfig(tol=0.0, max_iter=K, dtype=prob.b.dtype)
        chain = lambda: solve(prob.A, prob.b, method=method,  # noqa: E731
                              cfg=cfg, precond=precond)
        return _graph(chain) if graph else chain

    sec = _slope_time(make_chain, K1=max(2, iters // 6), K2=iters,
                      reps=reps)
    return {"iter_method": method, "time_per_iter_s": sec,
            "nnz": prob.csr.nnz,
            "spmv_equiv_nnz_per_s": 2 * prob.csr.nnz / sec}


def bench_batched_iteration(csr, dtype, k=8, method="bicgstab", iters=60,
                            graph=False, prob=None) -> dict:
    """Time per BATCHED solver iteration (api.solve_batched over k
    right-hand sides): the tol=0 slope of bench_iteration, eager or, with
    graph=True, as replayed CUDA graphs. The ratio that matters is
    k * time_per_iter(single) / time_per_iter(batched): how much of the
    band stream the batch amortises. B is k standard-normal rows from
    NumPy's generator seeded with 0; `prob`: a problem already built on
    the card (build_problem(csr, dtype)), to reuse."""
    from mpi_bicgstab_tpu_torch.api import solve_batched
    from mpi_bicgstab_tpu_torch.models.problem import build_problem
    from mpi_bicgstab_tpu_torch.ops.precision import df_from_f64
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig

    _require_cuda()
    if prob is None:
        prob = build_problem(csr, dtype=dtype, multiple=1)
    B_host = np.random.default_rng(0).standard_normal((k, prob.n))
    dev = prob.A.device
    B = df_from_f64(B_host, dev) if dtype == "df32" else torch.as_tensor(
        B_host, dtype=prob.b.dtype, device=dev)

    def make_chain(K):
        cfg = SolverConfig(tol=0.0, max_iter=K, dtype=dtype)
        chain = lambda: solve_batched(prob.A, B, method=method,  # noqa: E731
                                      cfg=cfg)
        return _graph(chain) if graph else chain

    sec = _slope_time(make_chain, K1=max(2, iters // 6), K2=iters, reps=3)
    return {"iter_method": method, "batch": k, "time_per_iter_s": sec,
            "nnz": csr.nnz, "graph": graph}


def bench_shifted_iteration(csr, dtype, sigma_len=512, seed=255,
                            method="shifted_lopbicg_switching", iters=40,
                            shift_block=-1, graph=False, prob=None) -> dict:
    """Time per iteration of the SHIFTED family, the reference's flagship
    workload (its hot phase is the sigma_len x n shift-update traffic,
    shifted_switching_solver.c:429-445). The slope method of
    bench_iteration: with tol=0 no shift converges, so exactly max_iter
    seed iterations and full-ladder shift updates run, and the loop reads
    nothing from the device (graph=True captures each chain). The ladder
    is main_shifted.c:95-100's, sigma_i = (i + 1) 0.01 / sigma_len, and
    b = (A + sigma_seed I) ones. `prob`: a problem already built that way
    on the card (build_problem(csr, dtype, sigma_seed=...)), to reuse.

    shift_update_GBps divides the shift update's byte floor, two reads
    and two writes of the [S, n] x_set / p_set state (4 S n elem bytes,
    elem 8 for float64 and df32, 4 for float32), by the time per
    iteration."""
    from mpi_bicgstab_tpu_torch.api import _ladder, solve_shifted
    from mpi_bicgstab_tpu_torch.models.problem import build_problem
    from mpi_bicgstab_tpu_torch.solvers.switching_blocked import \
        resolve_block
    from mpi_bicgstab_tpu_torch.utils.config import ShiftedConfig

    _require_cuda()
    sigma = (np.arange(sigma_len, dtype=np.float64) + 1) * (0.01 / sigma_len)
    seed = min(seed, sigma_len - 1)
    if prob is None:
        prob = build_problem(csr, dtype=dtype, multiple=1,
                             sigma_seed=float(sigma[seed]))
    sig = _ladder(prob.b, sigma)     # on the card before any capture
    # the blocked path flushes every L iterations: both chains then run
    # whole blocks, so the slope carries one L-th of a flush per iteration
    L = resolve_block(ShiftedConfig(max_iter=iters, dtype=dtype,
                                    shift_block=shift_block),
                      prob.b, sigma_len) \
        if method == "shifted_lopbicg_switching" else 0
    K1, K2 = (L, max(2, iters // L) * L) if L else (max(2, iters // 6),
                                                    iters)

    def make_chain(K):
        cfg = ShiftedConfig(tol=0.0, max_iter=K, dtype=dtype,
                            shift_block=L or shift_block)
        chain = lambda: solve_shifted(prob.A, prob.b, sig,  # noqa: E731
                                      seed=seed, method=method, cfg=cfg)
        return _graph(chain) if graph else chain

    sec = _slope_time(make_chain, K1=K1, K2=K2, reps=3)
    elem = 4 if dtype in ("float32", torch.float32) else 8
    bytes_iter = 4 * sigma_len * csr.nrows * elem
    return {"iter_method": method, "sigma_len": sigma_len,
            "time_per_iter_s": sec, "n": csr.nrows,
            "shift_block": L or shift_block, "graph": graph,
            "chains": (K1, K2),
            "shift_update_bytes": bytes_iter,
            "shift_update_GBps": bytes_iter / sec / 1e9}


def bench_cheby(prob, lo: float, hi: float, degree: int = 8) -> dict:
    """Chebyshev application time p(A) v on prob's float32 or df32 DIA
    operator (JAX run_bench --what cheby, runner.py:504-570): the chain
    kernel (ops/cuda_cheby) against the unfused chain, ops/cheby.cheby_apply
    over the DIA SpMV kernel, each as replayed CUDA graphs of 30
    back-to-back applications on one standard-normal v (NumPy, seed 0)."""
    from mpi_bicgstab_tpu_torch.ops import cuda_cheby
    from mpi_bicgstab_tpu_torch.ops.cheby import cheby_apply
    from mpi_bicgstab_tpu_torch.ops.layout import spmv
    from mpi_bicgstab_tpu_torch.ops.precision import df_from_f64, is_df

    _require_cuda()
    A = prob.A
    v_host = np.random.default_rng(0).standard_normal(prob.n)
    df = is_df(A.vals)
    v = df_from_f64(v_host, A.device) if df else torch.as_tensor(
        v_host, dtype=A.vals.dtype, device=A.device)
    chain = cuda_cheby.cheby_chain_df if df else cuda_cheby.cheby_chain
    fused = time_call(lambda: chain(A.vals, v, A.offsets, degree, lo, hi),
                      iters=30, graph=True)
    unfused = time_call(lambda: cheby_apply(lambda u: spmv(A, u), v, degree,
                                            lo, hi),
                        iters=30, graph=True)
    return {"cheby_degree": degree, "dtype": "df32" if df else "float32",
            "cheby_fused_apply_s": fused, "cheby_unfused_apply_s": unfused,
            "cheby_fused_speedup": unfused / fused}
