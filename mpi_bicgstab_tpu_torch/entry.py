"""Driver hooks (counterpart of __graft_entry__.py at the JAX package's
root).

    entry(device="cuda") -> (fn, example_args): one single-device step
        of the flagship solver, seed-switching shifted LOP-BiCG in
        float32 on a 512-row band with 4 shifts, seed 3; fn(b, sigma)
        returns (x_set, n_iter, final_relres)
    dryrun_multichip(n_devices, device="cuda") -> dict: the whole
        distributed surface once at a tiny shape on n_devices ranks
        (parallel/launch.py): the shifted switching solve, pipelined,
        df32 classic to a true residual below 1e-8, Chebyshev degree 2, a
        2-RHS batch, the halo-fused float32 classic and pipelined and the
        df32 classic at 8192 rows a rank, and the rows x sigma grid when
        n_devices >= 4 is even. Returns each part's n_iter and relres.

Both run on the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32


def _tiny_problem(n: int, dtype):
    """banded_random(n, [1, -1, w, -w], seed 0) with w = max(2, n^(1/3)),
    b = A 1 in `dtype` (host) and the ladder [0, 0.01, 0.05, 0.2]."""
    from mpi_bicgstab_tpu_torch.models.generators import banded_random
    w = max(2, int(round(n ** (1 / 3))))
    csr = banded_random(n, [1, -1, w, -w], seed=0)
    b = csr.matvec(np.ones(csr.nrows)).astype(dtype)
    sigma = np.asarray([0.0, 0.01, 0.05, 0.2], dtype=dtype)
    return csr, b, sigma


def entry(device="cuda"):
    """(fn, example_args): fn(b, sigma) runs shifted_lopbicg_switching
    (seed 3, tol 1e-5, at most 32 iterations, float32) over the generic
    SpMV of the 512-row problem built on `device`."""
    from mpi_bicgstab_tpu_torch.models.problem import build_problem
    from mpi_bicgstab_tpu_torch.ops.layout import spmv as generic_spmv
    from mpi_bicgstab_tpu_torch.parallel.comm import Comm
    from mpi_bicgstab_tpu_torch.solvers.switching import \
        shifted_lopbicg_switching
    from mpi_bicgstab_tpu_torch.utils.config import ShiftedConfig

    csr, _, sigma = _tiny_problem(512, np.float32)
    prob = build_problem(csr, dtype=F32, device=device)
    cfg = ShiftedConfig(tol=1e-5, max_iter=32, dtype=F32)
    A = prob.A

    def fn(b, sigma):
        res = shifted_lopbicg_switching(lambda v: generic_spmv(A, v), Comm(),
                                        b, sigma, 3, cfg)
        return res.x_set, res.n_iter, res.final_relres

    return fn, (prob.b, torch.as_tensor(sigma, device=prob.b.device))


def _summary(res) -> dict:
    return {"n_iter": res.n_iter, "relres": float(res.final_relres)}


def dryrun_rank(n_devices: int, device: str) -> dict:
    """dryrun_multichip's part on one rank of an n_devices world (a
    parallel/launch.py task): every solve is collective."""
    from mpi_bicgstab_tpu_torch.ops.cheby import ChebyPrecond, estimate_bounds
    from mpi_bicgstab_tpu_torch.ops.precision import df_to_f64
    from mpi_bicgstab_tpu_torch.parallel.driver import (
        put_partitioned, put_vector, solve_batched_distributed,
        solve_distributed, solve_shifted_distributed)
    from mpi_bicgstab_tpu_torch.parallel.mesh import make_row_mesh
    from mpi_bicgstab_tpu_torch.parallel.partition import partition_csr
    from mpi_bicgstab_tpu_torch.solvers.fused_dist import applicable
    from mpi_bicgstab_tpu_torch.utils.config import ShiftedConfig, SolverConfig

    out = {}
    csr, b, sigma = _tiny_problem(16 * n_devices, np.float32)
    part = partition_csr(csr, n_devices, dtype=F32)
    mesh = make_row_mesh(n_devices, device)

    # the flagship: the distributed shifted switching solve
    res = solve_shifted_distributed(
        part, b, sigma, seed=3, method="shifted_lopbicg_switching",
        cfg=ShiftedConfig(tol=1e-4, max_iter=8, dtype=F32), mesh=mesh)
    assert tuple(res.x_set.shape) == (4, part.n_global)
    out["shifted"] = _summary(res)
    # the classic pipelined path
    res = solve_distributed(part, b, method="pipe_bicgstab",
                            cfg=SolverConfig(tol=1e-4, max_iter=8, dtype=F32),
                            mesh=mesh)
    assert tuple(res.x.shape) == (part.n_global,)
    out["pipe"] = _summary(res)

    # double-float pairs over the same grid, to float64-class accuracy
    part_df = partition_csr(csr, n_devices, dtype="df32")
    res = solve_distributed(part_df, b, method="bicgstab",
                            cfg=SolverConfig(tol=1e-10, max_iter=64,
                                             dtype=F32), mesh=mesh)
    assert tuple(res.x.hi.shape) == (part_df.n_global,)
    b64 = np.asarray(b, np.float64)
    x64 = df_to_f64(res.x)[: csr.nrows]
    true_relres = float(np.linalg.norm(csr.matvec(x64) - b64)
                        / np.linalg.norm(b64))
    assert true_relres < 1e-8, (
        f"df32 distributed solve true relres {true_relres:.3e} not at "
        f"float64-class accuracy")
    out["df32"] = {**_summary(res), "true_relres": true_relres}

    # Chebyshev right-preconditioning and a 2-RHS batch
    lo, hi = estimate_bounds(csr)
    res = solve_distributed(part, b, method="bicgstab",
                            cfg=SolverConfig(tol=1e-4, max_iter=8, dtype=F32),
                            mesh=mesh, precond=ChebyPrecond(2, lo, hi))
    out["cheby"] = _summary(res)
    res = solve_batched_distributed(
        part, np.stack([b, 2.0 * b]), method="bicgstab",
        cfg=SolverConfig(tol=1e-4, max_iter=8, dtype=F32, restarts=0),
        mesh=mesh)
    assert tuple(res.x.shape) == (2, part.n_global)
    out["batched"] = {"n_iter": [int(k) for k in res.n_iter],
                      "relres": [float(r) for r in res.final_relres]}

    # the halo-fused iterations (solvers/fused_dist.py) at 8192 rows a
    # rank: float32 classic and pipelined, df32 classic
    csr_hf, b_hf, _ = _tiny_problem(8192 * n_devices, np.float32)
    for name, method, dtype in (("fused_classic", "bicgstab", F32),
                                ("fused_pipe", "pipe_bicgstab", F32),
                                ("fused_df32", "bicgstab", "df32")):
        part_hf = partition_csr(csr_hf, n_devices, dtype=dtype, align=8192)
        cfg = SolverConfig(tol=1e-4, max_iter=4, dtype=dtype)
        assert applicable(put_partitioned(part_hf, mesh), method,
                          put_vector(b_hf, part_hf, mesh), cfg), name
        res = solve_distributed(part_hf, b_hf, method=method, cfg=cfg,
                                mesh=mesh)
        x = res.x.hi if dtype == "df32" else res.x
        assert tuple(x.shape) == (part_hf.n_global,)
        out[name] = _summary(res)

    # the rows x sigma grid: the ladder's [S, n] slabs on a second axis
    if n_devices >= 4 and n_devices % 2 == 0:
        part2 = partition_csr(csr, n_devices // 2, dtype=F32)
        res = solve_shifted_distributed(
            part2, b, sigma, seed=3, method="shifted_lopbicg_switching",
            cfg=ShiftedConfig(tol=1e-4, max_iter=8, dtype=F32,
                              shift_block=0),
            sigma_devices=2)
        assert tuple(res.x_set.shape) == (4, part2.n_global)
        out["grid"] = _summary(res)
    return out


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """dryrun_rank on n_devices fresh ranks (parallel/launch.run); a
    process that already is the one rank of a one-rank world runs it in
    place. Returns rank 0's dict."""
    import torch.distributed as dist

    from mpi_bicgstab_tpu_torch.parallel import launch
    dev = torch.device(device).type
    if dist.is_initialized() and dist.get_world_size() == n_devices == 1:
        return launch.to_host(dryrun_rank(1, dev))
    return launch.run(dryrun_rank, n_devices, n_devices, dev, device=dev)
