"""Per-shift refinement: batched BiCGStab over the shift axis (counterpart
of mpi_bicgstab_tpu/solvers/refine.py).

Why: the shifted family builds every x_j from collinearity recurrences
that are never re-anchored to the true residuals, so the TRUE per-shift
errors drift above the estimated residuals over long runs (measured in
the JAX package: ~4.7e-11 in f64 and ~1e-3 in df32 at ~1,800 iterations
on transport_hard). After the shifted solve, every shift is polished
independently but simultaneously: one batched BiCGStab over the [S, n]
state, each row solving (A + sigma_j I) x_j = b warm-started at the
recurrence solution. Per iteration: two shifted operator applications
(each row's SpMV through the port's SpMV, dia_spmv / dia_spmv_df on a DIA
matrix, plus the sigma scaling) and rowwise dots; converged rows freeze
under a mask (like the per-shift stopping of shifted_switching_solver.c:
136-149). The loop's condition is one host read per iteration.

Works for float32 / float64 tensors and df32 DF pairs.
"""
from __future__ import annotations

import torch

from mpi_bicgstab_tpu_torch.ops.precision import (DF, df_dot, df_stack,
                                                  is_df, vfma, vvalue,
                                                  vwhere)
from mpi_bicgstab_tpu_torch.utils.config import SolverConfig


def _row_dot(comm, u, v):
    """Per-row dot of [S, n] operands -> [S] (compensated for DF)."""
    if is_df(u) or is_df(v):
        return comm.allreduce(df_dot(u, v, axis=-1))
    return comm.allreduce((u * v).sum(-1))


def _col(a):
    """[S] -> [S, 1] for rowwise scalar broadcasting (DF-aware)."""
    return a[:, None]


def _bcast(b, S: int):
    """[n] -> [S, n] broadcast view."""
    if is_df(b):
        return DF(b.hi.expand(S, -1), b.lo.expand(S, -1))
    return b.expand(S, -1)


def _shifted_op(spmv, sigma):
    """[S, n] -> [S, n]: row j gets (A + sigma_j I) x_j, one SpMV per row
    (the JAX package vmaps the base operator; the batched SpMV kernel is
    ROADMAP slice 5)."""
    def op(x_set):
        rows = [spmv(x_set[j]) for j in range(x_set.shape[0])]
        ys = df_stack(rows) if is_df(x_set) else torch.stack(rows)
        return ys + _col(sigma) * x_set
    return op


def refine_shifted(spmv, comm, b, sigma, x_set, cfg: SolverConfig):
    """Polish x_set so that each row's TRUE residual meets cfg.tol ||b||.

    Returns (x_set, n_iter, true_relres [S]). Rows already below the
    tolerance are returned untouched (masked from iteration 0)."""
    op = _shifted_op(spmv, sigma)
    S = x_set.shape[0]
    tol2 = torch.full((), cfg.tol, dtype=b.dtype, device=b.device) ** 2
    bTb = _row_dot(comm, _bcast(b, 1), _bcast(b, 1))[0]
    r = _bcast(b, S) - op(x_set)
    r_hat = p = r
    rTr = dot_r = _row_dot(comm, r, r)
    thresh = vvalue(bTb) * vvalue(tol2)
    live = vvalue(rTr) > thresh
    x, k = x_set, 0
    while k < cfg.max_iter and bool(live.any()):
        s = op(p)
        rTs = _row_dot(comm, r_hat, s)
        alpha = rTr / rTs
        q = vfma(r, -_col(alpha), s)
        y = op(q)
        qTy = _row_dot(comm, q, y)
        yTy = _row_dot(comm, y, y)
        omega = qTy / yTy
        x_new = vfma(vfma(x, _col(alpha), p), _col(omega), q)
        r_new = vfma(q, -_col(omega), y)
        dot_new = _row_dot(comm, r_new, r_new)
        rTr_new = _row_dot(comm, r_hat, r_new)
        beta = (alpha / omega) * (rTr_new / rTr)
        p_new = vfma(r_new, _col(beta), vfma(p, -_col(omega), s))
        m = live[:, None]
        x = vwhere(m, x_new, x)
        r = vwhere(m, r_new, r)
        p = vwhere(m, p_new, p)
        rTr = vwhere(live, rTr_new, rTr)
        dot_r = vwhere(live, dot_new, dot_r)
        live = live & (vvalue(dot_r) > thresh)
        k += 1
    return x, k, torch.sqrt(vvalue(dot_r) / vvalue(bTb))
