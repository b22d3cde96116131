"""SpMV and solver-iteration timing on the card (counterpart of
mpi_bicgstab_tpu/benchmarks/runner.py: `_slope_time`, `bench_spmv`,
`bench_iteration`, `bench_batched_iteration`, `bench_shifted_iteration`,
`bench_cheby` (the `--what cheby` section of its run_bench),
`bench_overlap`, `bench_scaling` and `run_bench`, the CLI's `bench`
command).

The distributed forms (`bench_spmv_dist`, `bench_iteration_dist`,
`bench_shifted_dist`, `bench_overlap`, `bench_scaling`; `bench --devices
N`, `--what overlap,scaling`) are called on every rank of a world that
parallel/launch.py started (the CLI spawns it as `solve --devices`
does); they time through parallel/driver.py, and rank 0's clock is the
one reported.

Every time is a slope: the timed operation runs as a chain of K1 and of
K2 back-to-back calls on the current stream, each chain timed with CUDA
events, and cost per call = (t(K2) - t(K1)) / (K2 - K1), so the fixed
cost of a chain (the solver's r0 and true-residual SpMVs, the first
launch's latency) cancels. The result is the median of several slopes.
The events measure stream time, which includes any gap the host leaves
between launches: a host-bound loop shows as such. time_call(graph=True)
captures each chain in a CUDA graph first, so that the replay measures
the device's own time for the launches with no host in between. The
bench itself runs on the card only; `_slope_time` and
`bench_shifted_iteration` also take device="cpu", where the chains are
timed on the host's clock (the `profile` command's CPU path,
benchmarks/sections.py).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch

# vs_baseline anchors the SpMV rate to an estimated 4.0e9 nnz/s per
# A64FX process domain, the reference's device (one CMG: ~256 GB/s HBM2
# feeding a ~12.7 B/nnz f64 CSR kernel at the ~20% efficiency typical of
# unstructured SpMV there), the per-device unit of its strong-scaling
# plots; the reference publishes plots, not numbers
REF_SPMV_NNZ_PER_S = 4.0e9


def _require_cuda():
    if not torch.cuda.is_available():
        raise RuntimeError("timing needs a CUDA device; there is none")


def _chain_seconds(chain, device: str = "cuda") -> float:
    if device == "cpu":
        t0 = time.perf_counter()
        chain()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    chain()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _slope_time(make_chain, K1=10, K2=60, reps=5,
                device: str = "cuda") -> float:
    """Seconds per operation: median over `reps` of the slope between a
    K1-long and a K2-long chain (make_chain(K) returns a callable that
    runs K operations); CUDA events on the card, the host's clock for
    device="cpu". As in the JAX package's _slope_time, a slope that noise
    made non-positive (a busy host's clock) is dropped; if every one is,
    the slope of the chains' totals stands in, and failing that the long
    chain's time per operation, so that no time is ever non-positive."""
    if device != "cpu":
        _require_cuda()
    c1, c2 = make_chain(K1), make_chain(K2)
    c1()
    c2()
    if device != "cpu":
        torch.cuda.synchronize()
    slopes, t1s, t2s = [], 0.0, 0.0
    for _ in range(reps):
        t1 = _chain_seconds(c1, device)
        t2 = _chain_seconds(c2, device)
        slopes.append((t2 - t1) / (K2 - K1))
        t1s, t2s = t1s + t1, t2s + t2
    pos = [v for v in slopes if v > 0]
    if pos:
        return float(np.median(pos))
    agg = (t2s - t1s) / (reps * (K2 - K1))
    return float(agg if agg > 0 else t2s / (reps * K2))


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


def time_call(fn, iters=60, reps=5, graph=False,
              device: str = "cuda") -> float:
    """Seconds per call of fn() (any launches on the current stream):
    with graph=False as the host issues them, with graph=True the
    device's time alone (the chains are replayed CUDA graphs; the card
    only)."""
    def make_chain(K):
        def chain():
            for _ in range(K):
                fn()
        return _graph(chain) if graph else chain
    return _slope_time(make_chain, K1=max(2, iters // 6), K2=iters,
                       reps=reps, device=device)


def bench_spmv(prob, iters=60, seed=0) -> dict:
    """SpMV time and rate of prob.A on a random x (layout.spmv, so the
    DIA kernel for a DiaMatrix on the card). Rate = nnz of the host CSR
    per second, as the JAX bench reports it; the windowed-ELL and
    butterfly layouts add their padded widths (and the butterfly its
    window count P)."""
    from mpi_bicgstab_tpu_torch.ops.layout import spmv
    from mpi_bicgstab_tpu_torch.ops.precision import df_from_f64, is_df
    x_host = np.random.default_rng(seed).standard_normal(prob.n)
    x = df_from_f64(x_host, prob.A.device) if is_df(prob.b) else \
        torch.as_tensor(x_host, dtype=prob.b.dtype, device=prob.b.device)
    sec = time_call(lambda: spmv(prob.A, x), iters=iters,
                    device=prob.A.device.type)
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
                      reps=reps, device=prob.A.device.type)
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
                            shift_block=-1, graph=False, prob=None,
                            device: str = "cuda") -> dict:
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
    iteration. device="cpu" builds and times on the CPU (host clock)."""
    from mpi_bicgstab_tpu_torch.api import _ladder, solve_shifted
    from mpi_bicgstab_tpu_torch.models.problem import build_problem
    from mpi_bicgstab_tpu_torch.solvers.switching_blocked import \
        resolve_block
    from mpi_bicgstab_tpu_torch.utils.config import ShiftedConfig

    if device != "cpu":
        _require_cuda()
    sigma = (np.arange(sigma_len, dtype=np.float64) + 1) * (0.01 / sigma_len)
    seed = min(seed, sigma_len - 1)
    if prob is None:
        prob = build_problem(csr, dtype=dtype, multiple=1, device=device,
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

    sec = _slope_time(make_chain, K1=K1, K2=K2, reps=3, device=device)
    elem = 4 if dtype in ("float32", torch.float32) else 8
    bytes_iter = 4 * sigma_len * csr.nrows * elem
    return {"iter_method": method, "sigma_len": sigma_len,
            "time_per_iter_s": sec, "n": csr.nrows,
            "shift_block": L or shift_block, "graph": graph,
            "chains": (K1, K2),
            "shift_update_bytes": bytes_iter,
            "shift_update_GBps": bytes_iter / sec / 1e9}


def bench_cheby(prob, lo: float, hi: float, degree: int = 8) -> dict:
    """Chebyshev application time p(A) v on prob's operator (JAX run_bench
    --what cheby, runner.py:504-570): the unfused chain,
    ops/cheby.cheby_apply over layout.spmv, and, where a chain kernel
    takes the operator (a float32 or df32 DIA one, ops/cuda_cheby), the
    kernel; each as replayed CUDA graphs of 30 back-to-back applications
    on one standard-normal v (NumPy, seed 0)."""
    from mpi_bicgstab_tpu_torch.ops import cuda_cheby
    from mpi_bicgstab_tpu_torch.ops.cheby import cheby_apply
    from mpi_bicgstab_tpu_torch.ops.layout import spmv
    from mpi_bicgstab_tpu_torch.ops.precision import df_from_f64, is_df

    _require_cuda()
    A = prob.A
    v_host = np.random.default_rng(0).standard_normal(prob.n)
    df = is_df(prob.b)
    v = df_from_f64(v_host, A.device) if df else torch.as_tensor(
        v_host, dtype=prob.b.dtype, device=A.device)
    unfused = time_call(lambda: cheby_apply(lambda u: spmv(A, u), v, degree,
                                            lo, hi),
                        iters=30, graph=True)
    out = {"cheby_degree": degree,
           "dtype": "df32" if df else str(prob.b.dtype).removeprefix(
               "torch."),
           "cheby_unfused_apply_s": unfused,
           "cheby_fused_available": cuda_cheby.format_ok(A, v.dtype,
                                                         degree)}
    if out["cheby_fused_available"]:
        chain = cuda_cheby.cheby_chain_df if df else cuda_cheby.cheby_chain
        fused = time_call(lambda: chain(A.vals, v, A.offsets, degree, lo,
                                        hi), iters=30, graph=True)
        out.update(cheby_fused_apply_s=fused,
                   cheby_fused_speedup=unfused / fused)
    return out


# --- the distributed forms: called on every rank of a world ------------------

def _part(csr, dtype, devices: int, device: str):
    """(this rank's grid, its shard of csr's partition; the partition
    itself on a rank beyond the grid)."""
    from mpi_bicgstab_tpu_torch.parallel.driver import put_partitioned
    from mpi_bicgstab_tpu_torch.parallel.mesh import make_row_mesh
    from mpi_bicgstab_tpu_torch.parallel.partition import partition_csr
    part = partition_csr(csr, devices, dtype=dtype)
    mesh = make_row_mesh(devices, device)
    return mesh, put_partitioned(part, mesh) if mesh.member else part


def _dist_iter_time(csr, dtype, devices, method, iters, device,
                    serialize: bool = False, unfused: bool = False):
    """Seconds per iteration of solve_distributed over `devices` ranks
    (tol = 0 chains, the slope of bench_iteration)."""
    from mpi_bicgstab_tpu_torch.parallel.driver import solve_distributed
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
    mesh, shard = _part(csr, dtype, devices, device)
    b = csr.matvec(np.ones(csr.nrows))

    def make_chain(K):
        cfg = SolverConfig(tol=0.0, max_iter=K, dtype=dtype,
                           serialize_comm=serialize)
        return lambda: solve_distributed(shard, b, method=method, cfg=cfg,
                                         mesh=mesh, unfused=unfused)

    return _slope_time(make_chain, K1=max(2, iters // 6), K2=iters,
                       reps=3, device=device)


def bench_spmv_dist(csr, dtype, devices: int, iters=60,
                    device: str = "cuda") -> dict:
    """The distributed SpMV's time and rate over `devices` ranks (JAX
    bench_spmv with devices > 1): a chain of local SpMVs, each output
    scaled by one global reduction so that the chain depends on every
    rank, as the JAX chain does."""
    from mpi_bicgstab_tpu_torch.parallel.driver import (make_local_spmv,
                                                        put_vector,
                                                        row_comm)
    mesh, shard = _part(csr, dtype, devices, device)
    comm = row_comm(mesh)
    spmv = make_local_spmv(shard, comm)
    x0 = put_vector(np.random.default_rng(0).standard_normal(
        shard.n_global), shard, mesh)

    def make_chain(K):
        def chain():
            v = x0
            for _ in range(K):
                y = spmv(v)
                v = y / (1.0 + comm.allreduce(y.abs().sum()))
            return v
        return chain

    sec = _slope_time(make_chain, K1=max(2, iters // 6), K2=iters,
                      device=device)
    return {"spmv_s": sec, "spmv_nnz_per_s": csr.nnz / sec,
            "spmv_layout": None}


def bench_iteration_dist(csr, dtype, devices: int, method="pipe_bicgstab",
                         iters=60, device: str = "cuda") -> dict:
    """bench_iteration through solve_distributed over `devices` ranks."""
    sec = _dist_iter_time(csr, dtype, devices, method, iters, device)
    return {"iter_method": method, "time_per_iter_s": sec,
            "nnz": csr.nnz, "spmv_equiv_nnz_per_s": 2 * csr.nnz / sec}


def bench_shifted_dist(csr, dtype, devices: int, sigma_len=512, seed=255,
                       method="shifted_lopbicg_switching", iters=40,
                       shift_block=-1, device: str = "cuda") -> dict:
    """bench_shifted_iteration through solve_shifted_distributed over
    `devices` ranks (JAX bench_shifted_iteration with devices > 1)."""
    from mpi_bicgstab_tpu_torch.parallel.driver import \
        solve_shifted_distributed
    from mpi_bicgstab_tpu_torch.utils.config import ShiftedConfig
    sigma = (np.arange(sigma_len, dtype=np.float64) + 1) * (0.01 / sigma_len)
    seed = min(seed, sigma_len - 1)
    mesh, shard = _part(csr, dtype, devices, device)
    b = csr.matvec(np.ones(csr.nrows)) + sigma[seed] * np.ones(csr.nrows)

    def make_chain(K):
        cfg = ShiftedConfig(tol=0.0, max_iter=K, dtype=dtype,
                            shift_block=shift_block)
        return lambda: solve_shifted_distributed(
            shard, b, sigma, seed=seed, method=method, cfg=cfg, mesh=mesh)

    sec = _slope_time(make_chain, K1=max(2, iters // 6), K2=iters, reps=3,
                      device=device)
    elem = 4 if dtype in ("float32", torch.float32) else 8
    bytes_iter = 4 * sigma_len * csr.nrows * elem
    return {"iter_method": method, "sigma_len": sigma_len,
            "time_per_iter_s": sec, "n": csr.nrows,
            "shift_block": shift_block,
            "shift_update_GBps": bytes_iter / sec / 1e9}


def _fabric(points: int, device: str) -> str:
    """What a sweep's collectives crossed: nothing for one rank."""
    if points <= 1:
        return "single-device (no fabric exercised)"
    return "cuda-nccl" if device == "cuda" else "cpu-gloo"


def bench_overlap(csr, dtype, devices: int = 1, method="pipe_bicgstab",
                  iters=60, device: str = "cuda") -> dict:
    """The reference's nooverlap A/B (shifted_switching_solver.c:611-
    1016, JAX runner.py:357-415): time per iteration of the distributed
    unfused solver over `devices` ranks with the reductions overlapped by
    the SpMVs placed between their start and wait (parallel/comm.py)
    against the same solve with cfg.serialize_comm, where every
    collective completes before the compute that would hide it. Both
    sides run the unfused solver (the serialized side by rule, the
    overlapped one by solve_distributed(unfused=True)), so the gap is the
    overlap alone, not kernel fusion. overlap_fabric says what the
    collectives crossed: on one rank nothing is hidden, and the gain
    shows only where the host issues the waits."""
    t_overlap = _dist_iter_time(csr, dtype, devices, method, iters, device,
                                unfused=True)
    t_serial = _dist_iter_time(csr, dtype, devices, method, iters, device,
                               serialize=True)
    return {"overlap_method": method,
            "time_per_iter_overlap_s": t_overlap,
            "time_per_iter_serialized_s": t_serial,
            "overlap_gain": t_serial / t_overlap,
            "overlap_fabric": _fabric(devices, device)}


def bench_scaling(csr, dtype, max_devices: int = 8, method="pipe_bicgstab",
                  iters=40, device: str = "cuda") -> dict:
    """Strong-scaling sweep (JAX runner.py:418-450): the same global
    problem over 1, 2, 4, ... ranks up to min(max_devices, the world's
    ranks), speedup in time per iteration against one rank. scaling_fabric
    labels what the sweep crossed: a one-point sweep none, several CUDA
    ranks NCCL, CPU ranks gloo."""
    import torch.distributed as dist
    avail = dist.get_world_size()
    sizes = [d for d in (1, 2, 4, 8, 16, 32)
             if d <= min(max_devices, avail)]
    out = {"scaling_method": method, "scaling_devices": sizes}
    t1 = None
    for d in sizes:
        t = _dist_iter_time(csr, dtype, d, method, iters, device)
        out[f"time_per_iter_s_d{d}"] = t
        t1 = t if t1 is None else t1
        out[f"speedup_d{d}"] = t1 / t
    out["scaling_fabric"] = _fabric(max(sizes), device)
    return out


def card_census() -> dict:
    """The card's name and power limit as nvidia-smi reports them
    (`--query-gpu=name,power.limit`), and the count of cards; None where
    there is no card or no nvidia-smi."""
    out = {"device_count": torch.cuda.device_count()
           if torch.cuda.is_available() else 0,
           "device_name": None, "power_limit": None}
    if out["device_count"]:
        out["device_name"] = torch.cuda.get_device_name(0)
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        out["power_limit"] = line.split(",")[-1].strip()
    except (OSError, IndexError, subprocess.SubprocessError):
        pass
    return out


def _keep(d: dict, keys) -> dict:
    return {k: d[k] for k in keys if k in d}


# each section's keys in the JAX package's bench line (runner.py:453-592)
SPMV_KEYS = ("spmv_s", "spmv_nnz_per_s", "spmv_layout",
             "spmv_window_width")
ITER_KEYS = ("iter_method", "time_per_iter_s", "nnz",
             "spmv_equiv_nnz_per_s")
SHIFTED_KEYS = ("iter_method", "sigma_len", "time_per_iter_s", "n",
                "shift_block", "shift_update_GBps")
SECTIONS = ("spmv", "iter", "shifted", "cheby", "batched", "overlap",
            "scaling")
SINGLE_DEVICE = ("cheby", "batched")     # as in the JAX run_bench
OVERLAP_KEYS = ("overlap_method", "time_per_iter_overlap_s",
                "time_per_iter_serialized_s", "overlap_gain",
                "overlap_fabric")


def _shifted_problem(prob, sigma_seed: float):
    """prob with b = (A + sigma_seed I) ones over its logical rows (the
    shifted solvers' right-hand side), its operator shared."""
    from mpi_bicgstab_tpu_torch.ops.precision import (df_from_f64, is_df,
                                                      vzeros_like)
    ones = np.zeros(prob.n)
    ones[: prob.n_logical] = 1.0
    b_host = prob.csr.matvec(ones) + sigma_seed * ones
    b_host[prob.n_logical:] = 0.0
    dev = prob.A.device
    b = df_from_f64(b_host, dev) if is_df(prob.b) else torch.as_tensor(
        b_host, dtype=prob.b.dtype, device=dev)
    return dataclasses.replace(prob, b=b, x0=vzeros_like(b))


def _sections(args) -> list:
    what = args.what.split(",")
    for w in what:
        if w not in SECTIONS:
            raise SystemExit(f"--what: unknown section {w!r}; choose from "
                             f"{', '.join(SECTIONS)}")
        if w in SINGLE_DEVICE and getattr(args, "devices", 1) > 1:
            raise SystemExit(f"--what {w} is single-device")
    return what


def run_bench(args, device=None) -> int:
    """The CLI's `bench`: one JSON line with the JAX package's keys for
    each section of args.what (spmv, iter, shifted, cheby, batched,
    overlap, scaling) on the problem the `solve` command builds for
    args.matrix, beside the card's name and power limit. On the card
    unless args.device is "cpu" (then the host clock times spmv, iter,
    shifted, overlap and scaling). With --devices N > 1, or for overlap
    and scaling, it spawns N ranks as `solve --devices` does (NCCL on the
    cards, gloo on the CPU) and rank 0 prints the line. `device` (a
    caller's) overrides args.device. cheby and batched time CUDA graphs:
    they need the card whatever the device."""
    import argparse

    from mpi_bicgstab_tpu_torch.utils.device import resolve_device
    _sections(args)
    args = argparse.Namespace(**{"devices": 1, "device": "cuda",
                                 **vars(args)})
    if device is not None:
        args.device = str(device)
    if args.devices < 1:
        raise SystemExit("--devices must be >= 1")
    if args.devices > 1 or {"overlap", "scaling"} & set(
            args.what.split(",")):
        from mpi_bicgstab_tpu_torch.cli import _spawn
        return _spawn(bench_rank, args, args.devices)
    if args.device == "cuda":
        _require_cuda()
    print(json.dumps(bench_report(args, resolve_device(args.device))),
          flush=True)
    return 0


def bench_rank(args) -> int:
    """`bench` on one rank of the world _spawn started; rank 0 prints."""
    import torch.distributed as dist
    out = bench_report(args)
    if dist.get_rank() == 0:
        print(json.dumps(out), flush=True)
    return 0


def bench_report(args, dev=None) -> dict:
    """The bench line of args as a dict (run_bench's sections). Called in
    the one process of a single-device bench (dev its device), or on
    every rank of a world (dev None: the rank's device)."""
    from mpi_bicgstab_tpu_torch.cli import _build_problem, _load_matrix
    from mpi_bicgstab_tpu_torch.ops.cheby import estimate_bounds

    what = _sections(args)
    if dev is None:
        from mpi_bicgstab_tpu_torch.parallel.mesh import make_row_mesh
        dev = make_row_mesh(args.devices, args.device).device
    device = dev.type
    if device == "cuda":
        _require_cuda()
    if args.layout_cache:
        # the helpers build operators themselves: the environment's
        # default reaches them all (ops/layout.build_operator)
        os.environ["MBT_LAYOUT_CACHE"] = args.layout_cache
    dtype = args.dtype if args.dtype == "df32" else getattr(torch,
                                                            args.dtype)
    csr, io_time = _load_matrix(args.matrix)
    card = card_census()
    out = {"matrix": args.matrix, "n": csr.nrows, "nnz": csr.nnz,
           "dtype": args.dtype, "devices": args.devices,
           "backend": device, "io_time_s": round(io_time, 4),
           "device_name": card["device_name"],
           "power_limit": card["power_limit"]}
    D = args.devices
    prob = _build_problem(csr, dtype, dev, layout_cache=args.layout_cache) \
        if D == 1 and set(what) - {"overlap", "scaling"} else None
    if "spmv" in what:
        r = bench_spmv(prob, iters=args.iters) if D == 1 else \
            bench_spmv_dist(csr, dtype, D, iters=args.iters, device=device)
        out.update(_keep(r, SPMV_KEYS))
        out["vs_baseline"] = out["spmv_nnz_per_s"] / REF_SPMV_NNZ_PER_S
    if "iter" in what:
        m = args.method or "pipe_bicgstab"
        r = bench_iteration(prob, method=m, iters=args.iters) if D == 1 \
            else bench_iteration_dist(csr, dtype, D, method=m,
                                      iters=args.iters, device=device)
        out.update(_keep(r, ITER_KEYS))
    if "shifted" in what:
        sigma = (np.arange(args.sigma_len) + 1) * (0.01 / args.sigma_len)
        seed = min(args.seed, args.sigma_len - 1)
        kw = {"method": args.method} if args.method else {}
        if D == 1:
            r = bench_shifted_iteration(
                csr, dtype, sigma_len=args.sigma_len, seed=seed,
                iters=args.iters, shift_block=args.shift_block,
                prob=_shifted_problem(prob, float(sigma[seed])),
                device=device, **kw)
        else:
            r = bench_shifted_dist(
                csr, dtype, D, sigma_len=args.sigma_len, seed=seed,
                iters=args.iters, shift_block=args.shift_block,
                device=device, **kw)
        out.update(_keep(r, SHIFTED_KEYS))
    if "overlap" in what:
        out.update(_keep(bench_overlap(csr, dtype, D, iters=args.iters,
                                       device=device), OVERLAP_KEYS))
    if "scaling" in what:
        kw = {"method": args.method} if args.method else {}
        out.update(bench_scaling(csr, dtype, max_devices=D,
                                 iters=args.iters, device=device, **kw))
    if "cheby" in what:
        lo, hi = estimate_bounds(csr)
        r = bench_cheby(prob, lo, hi, degree=8)
        out.update(cheby_degree=r["cheby_degree"],
                   # the JAX key's name; here the unfused chain over the
                   # SpMV, the counterpart of its XLA chain
                   cheby_xla_apply_s=r["cheby_unfused_apply_s"],
                   cheby_fused_available=r["cheby_fused_available"])
        if r["cheby_fused_available"]:
            out["cheby_fused_apply_s"] = r["cheby_fused_apply_s"]
            out["cheby_fused_speedup"] = round(r["cheby_fused_speedup"], 2)
    if "batched" in what:
        # like with like: the single-RHS iteration of the same method
        m = args.method or "bicgstab"
        if out.get("iter_method") == m:
            t1 = out["time_per_iter_s"]
        else:
            t1 = bench_iteration(prob, method=m,
                                 iters=args.iters)["time_per_iter_s"]
        t8 = bench_batched_iteration(csr, dtype, k=8, method=m,
                                     iters=args.iters,
                                     prob=prob)["time_per_iter_s"]
        out.update(batched8_method=m, batched8_single_time_per_iter_s=t1,
                   batched8_time_per_iter_s=t8,
                   batched8_per_rhs_speedup=round(8 * t1 / t8, 2))
    return out
