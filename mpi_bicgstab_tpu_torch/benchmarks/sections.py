"""Per-phase section timing, the CLI's `profile` (counterpart of
mpi_bicgstab_tpu/benchmarks/sections.py): the rebuild of the reference's
MEASURE_SECTION_TIME / DISPLAY_SECTION_TIME mode
(shifted_switching_solver.c:9-10,678-695,884-892,994-1005), which timed
allgather x2, diag-mult x2, offd-mult x2, allreduce and shift-update per
iteration and printed a CSV.

Each phase is timed as its own slope-benchmarked chain on the same data
(benchmarks/runner._slope_time): a chain step is the phase's operation
followed by v / (1 + sum|v|), the JAX package's normalisation that keeps
a long chain finite. On one device the chains are replayed CUDA graphs on
the card, the device's own time as the JAX package's jitted loops give
it (the CPU path times them eagerly on the host's clock); `shifted_iter`
and `shift_update` come from bench_shifted_iteration, the full ladder
less the seed alone. With devices > 1 the ranks of parallel/launch.py
time the distributed SpMV, the halo exchange, the gather and the global
dot, eagerly; rank 0's numbers are returned.

--trace DIR writes a torch.profiler trace (Chrome JSON) of one solve,
after an untimed one. Where the JAX package prints and goes on when its
trace fails (sections.py:177-178), this raises.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from mpi_bicgstab_tpu_torch.benchmarks.runner import (_graph, _slope_time,
                                                      bench_shifted_iteration)


def _chainer(x0, body, normalise, graph: bool):
    """make_chain(K) for _slope_time: K steps of v -> normalise(body(v))
    from x0, captured in a CUDA graph when `graph`."""
    def make(K):
        def chain():
            v = x0
            for _ in range(K):
                v = normalise(body(v))
            return v
        return _graph(chain) if graph else chain
    return make


def _local_norm(y):
    return y / (1.0 + y.abs().sum())


def _one_device(csr, dtype, sigma_len, iters, device):
    from mpi_bicgstab_tpu_torch.models.problem import build_problem
    from mpi_bicgstab_tpu_torch.ops.layout import spmv
    K1, K2 = max(2, iters // 6), iters
    prob = build_problem(csr, dtype=dtype, multiple=1024, device=device)
    x0 = torch.as_tensor(np.random.default_rng(0).standard_normal(prob.n),
                         dtype=prob.b.dtype, device=prob.b.device)
    graph = prob.b.device.type == "cuda"

    def slope(body):
        return _slope_time(_chainer(x0, body, _local_norm, graph), K1, K2,
                           device=prob.b.device.type)

    out = {"spmv": slope(lambda v: spmv(prob.A, v)),
           "axpy": slope(lambda v: v + 0.5 * v),
           "dot": slope(lambda v: v * (1.0 / (1.0 + torch.dot(v, v))))}
    if sigma_len:
        # the shift update's real cost: the switching solver at sigma_len
        # less the same solver with the seed alone (the subtraction the
        # reference's section CSV reports)
        kw = dict(iters=max(K2 // 2, 8), shift_block=0, graph=graph,
                  device=prob.b.device.type)
        full = bench_shifted_iteration(csr, dtype, sigma_len=sigma_len,
                                       seed=min(255, sigma_len - 1), **kw)
        seed_only = bench_shifted_iteration(csr, dtype, sigma_len=1, seed=0,
                                            **kw)
        out["shifted_iter"] = full["time_per_iter_s"]
        out["shift_update"] = max(
            full["time_per_iter_s"] - seed_only["time_per_iter_s"], 0.0)
    return out


def dist_sections(csr, dtype, devices: int, iters: int = 60) -> dict:
    """The distributed phases on this rank (call on every rank of the
    world; its first `devices` ranks take part): {phase: seconds}, None
    on a rank beyond them."""
    from mpi_bicgstab_tpu_torch.parallel.dist_spmv import exchange_halo
    from mpi_bicgstab_tpu_torch.parallel.driver import (make_local_spmv,
                                                        put_partitioned,
                                                        put_vector,
                                                        row_comm)
    from mpi_bicgstab_tpu_torch.parallel.mesh import make_row_mesh
    from mpi_bicgstab_tpu_torch.parallel.partition import partition_csr
    K1, K2 = max(2, iters // 6), iters
    mesh = make_row_mesh(devices)
    if not mesh.member:
        return None
    part = partition_csr(csr, devices, dtype=dtype)
    shard = put_partitioned(part, mesh)
    comm = row_comm(mesh)
    x0 = put_vector(np.random.default_rng(0).standard_normal(part.n_global),
                    part, mesh)
    n_loc = part.n_loc

    def norm(y):
        return y / (1.0 + comm.allreduce(y.abs().sum()))

    def slope(body):
        return _slope_time(_chainer(x0, body, norm, False), K1, K2,
                           device=mesh.device.type)

    out = {"spmv_total": slope(make_local_spmv(shard, comm))}
    if part.dia_mode == "halo" and part.halo > 0:
        h = part.halo

        def halo_only(v):
            xh = v.new_zeros(n_loc + 2 * h)
            exchange_halo(comm, h, [(v, xh)]).wait()
            return v + (xh[:h].sum() + xh[h + n_loc:].sum()) * 1e-30
        out["halo_exchange"] = slope(halo_only)

    def gather_only(v):
        g = comm.allgather(v)
        row = comm.rank * n_loc
        return v + g[row:row + n_loc] * 1e-30
    out["allgather"] = slope(gather_only)
    out["allreduce_dot"] = slope(
        lambda v: v * (1.0 / (1.0 + comm.dot(v, v))))
    return out


def profile_sections(csr, dtype, devices: int = 1, sigma_len: int = 0,
                     iters: int = 60, device="cuda") -> dict:
    """{phase: seconds} for the SpMV sub-phases, the reduction, the
    BLAS-1 update and (with sigma_len, one device) the shift update.
    devices > 1 starts that many ranks (parallel/launch.py)."""
    if devices == 1:
        return _one_device(csr, dtype, sigma_len, iters, device)
    from mpi_bicgstab_tpu_torch.parallel import launch
    return launch.run(dist_sections, devices, csr, dtype, devices, iters,
                      device=torch.device(device).type)


def trace_solve(csr, dtype, iters: int, trace_dir: str, device) -> str:
    """A torch.profiler trace (Chrome JSON) of one tol=0 solve of
    max(iters, 2) iterations, after an untimed one; returns its path."""
    from torch.profiler import ProfilerActivity, profile

    from mpi_bicgstab_tpu_torch.api import solve
    from mpi_bicgstab_tpu_torch.models.problem import build_problem
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
    prob = build_problem(csr, dtype=dtype, multiple=1024, device=device)
    cfg = SolverConfig(tol=0.0, max_iter=max(iters, 2), dtype=dtype)
    solve(prob.A, prob.b, cfg=cfg)          # builds and warms outside
    cuda = prob.b.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    with profile(activities=acts) as prof:
        r = solve(prob.A, prob.b, cfg=cfg)
        if cuda:
            torch.cuda.synchronize()
        float(r.final_relres)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


def run_profile(args) -> int:
    """The CLI's `profile`: one line of {phase}_s (JSON with --json)."""
    from mpi_bicgstab_tpu_torch.cli import _load_matrix
    from mpi_bicgstab_tpu_torch.utils.device import resolve_device
    dev = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    if dev.type == "cuda" and args.devices > torch.cuda.device_count():
        raise SystemExit(f"--devices {args.devices}: requested "
                         f"{args.devices} devices, only "
                         f"{torch.cuda.device_count()} CUDA device(s) "
                         f"present")
    csr, _ = _load_matrix(args.matrix)
    if args.trace:
        path = trace_solve(csr, dtype, args.iters, args.trace, dev)
        print(f"trace written to {path}")
    phases = profile_sections(csr, dtype, devices=args.devices,
                              sigma_len=args.sigma_len, iters=args.iters,
                              device=dev)
    payload = {"matrix": args.matrix, "n": csr.nrows, "nnz": csr.nnz,
               "devices": args.devices,
               **{f"{k}_s": round(v, 9) for k, v in phases.items()}}
    if args.json:
        print(json.dumps(payload), flush=True)
    else:
        for k, v in payload.items():
            print(f"{k:>20s}: {v}")
    return 0
