"""Classic BiCGStab, unfused (counterpart of `bicgstab` and `_finish` in
mpi_bicgstab_tpu/solvers/bicgstab.py; reference src/solver.c:35-146).

This is the route for float64 and for operators other than a float32
DiaMatrix; the float32 DIA route is ops/cuda_fused_classic.bicgstab_fused.
The other methods of the classic family (CA, pipelined, pipelined with
residual replacement, BiCGStab(l)) are ROADMAP slice 2.

The solver takes spmv: x -> A@x, a Comm for the global dots, b, x0 and a
SolverConfig. The loop runs on the host; the scalars stay on the device
as 0-d tensors, and the only host synchronisation per iteration is the
stop test (none at all when tol == 0).
"""
from __future__ import annotations

import torch

from mpi_bicgstab_tpu_torch.ops.blas import axpy
from mpi_bicgstab_tpu_torch.solvers.base import SolveResult, exact_iters
from mpi_bicgstab_tpu_torch.utils.config import SolverConfig


def _maybe_print_residual(cfg, k, dot_r, dot_zero):
    """DISPLAY_RESIDUAL (solver.c:8-9,122-126): print the relative
    residual every cfg.out_iter iterations (1-based labels)."""
    if cfg.out_iter and (k + 1) % cfg.out_iter == 0:
        print(f"iter {k + 1}: relres "
              f"{float(torch.sqrt(dot_r / dot_zero)):.6e}")


def _finish(x, k, dot_r, dot_zero, tol2, hist, max_iter, spmv, comm, b):
    """SolveResult with the true-residual gate: one extra SpMV at exit,
    because the recursive residual the loop stopped on can decouple from
    the truth (SolveResult.converged)."""
    relres = torch.sqrt(dot_r / dot_zero)
    history = torch.full((max_iter,), float("nan"), dtype=dot_zero.dtype,
                         device=dot_zero.device)
    if hist:
        history[:len(hist)] = torch.sqrt(torch.stack(hist) / dot_zero)
    r_true = b - spmv(x)
    true_relres = torch.sqrt(comm.dot(r_true, r_true) / dot_zero)
    tol = torch.sqrt(tol2)
    return SolveResult(x=x, n_iter=k, final_relres=relres, history=history,
                       converged=(dot_r <= dot_zero * tol2)
                       & (true_relres <= 100.0 * tol),
                       true_relres=true_relres)


def bicgstab(spmv, comm, b, x0, cfg: SolverConfig) -> SolveResult:
    """Classic BiCGStab (reference solver.c:35-146).

    Per iteration: 2 SpMV and the reference's reduction points — (r^,s)
    alone, then (q,y)+(y,y) together, then (r,r)+(r^,r) together
    (solver.c:89-114)."""
    tol2 = torch.tensor(cfg.tol, dtype=b.dtype, device=b.device) ** 2
    exact = exact_iters(cfg)

    r0 = b - spmv(x0)                                   # solver.c:74-75
    r_hat = r0                                          # solver.c:76
    rTr0 = comm.dot(r0, r0)                             # solver.c:78-80
    dot_zero = rTr0
    x, r, p = x0, r0, r0                                # solver.c:77
    rTr = dot_r = rTr0
    hist = []
    thresh = None if exact else float(dot_zero * tol2)
    k = 0
    while k < cfg.max_iter and (exact or float(dot_r) > thresh):  # :86
        s = spmv(p)                                     # solver.c:88
        rTs = comm.dot(r_hat, s)                        # solver.c:89-91
        alpha = rTr / rTs                               # solver.c:93
        q = axpy(-alpha, s, r)                          # solver.c:94
        y = spmv(q)                                     # solver.c:96
        qTy, yTy = comm.dots((q, y), (y, y))            # solver.c:97-102
        omega = qTy / yTy                               # solver.c:104
        x = axpy(omega, q, axpy(alpha, p, x))           # solver.c:105-106
        r_new = axpy(-omega, y, q)                      # solver.c:107
        dot_r, rTr_new = comm.dots((r_new, r_new),
                                   (r_hat, r_new))      # solver.c:108-114
        beta = (alpha / omega) * (rTr_new / rTr)        # solver.c:116
        p = axpy(beta, axpy(-omega, s, p), r_new)       # solver.c:117-119
        hist.append(dot_r)
        _maybe_print_residual(cfg, k, dot_r, dot_zero)
        r, rTr = r_new, rTr_new
        k += 1
    return _finish(x, k, dot_r, dot_zero, tol2, hist, cfg.max_iter, spmv,
                   comm, b)
