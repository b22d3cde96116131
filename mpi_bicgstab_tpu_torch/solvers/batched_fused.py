"""Batched classic BiCGStab over k right-hand sides with the band read
once per pass for the whole batch (counterpart of
mpi_bicgstab_tpu/solvers/batched_fused.py). The one driver is
bicgstab_batched_fully_fused: three fused passes per iteration over all
lanes (ops/cuda_fused_batched.py), the JAX
`_bicgstab_batched_fully_fused`.

api.solve_batched routes float32 bicgstab on a DiaMatrix with k <= 8
lanes (ops/cuda_batched_spmv.format_ok) to it. The JAX package's other
batched loop (`bicgstab_batched_fused`: XLA updates around its batched
SpMV kernel) serves operators whose fused passes' VMEM windows do not
fit; on the card nothing is staged, so the fused driver takes every
operator that loop would, and the port has no such loop.
B and X0 are [k, n] float32; the result is a SolveResult with a leading
batch axis on every field, n_iter a [k] int32 tensor on the host.

Semantics are jax.vmap(bicgstab)'s: the loop runs until the last lane
stops, a stopped lane's vectors and scalars freeze (its n_iter too, and
its history slots are NaN), so every lane's trajectory is the one it
would take alone; tol = 0 runs exactly max_iter iterations on every lane
(solvers.base.exact_iters); `converged` is gated on each lane's true
residual. The stop test reads the [k] dot_r once per iteration, and
nothing else crosses to the host; a tol = 0 solve reads nothing and
captures in a CUDA graph.
"""
from __future__ import annotations

import numpy as np
import torch

from mpi_bicgstab_tpu_torch.ops.cuda_batched_spmv import batched_dia_spmv
from mpi_bicgstab_tpu_torch.ops.cuda_fused_batched import (fused_k1b,
                                                           fused_k2b,
                                                           fused_k3b)
from mpi_bicgstab_tpu_torch.solvers.base import SolveResult, start


def _dot(u, v):
    return (u * v).sum(1)                       # per-lane [k]


class _Lanes:
    """The per-lane stop test and bookkeeping of a batched loop: which
    lanes are active (host and device), their iteration counts and the
    history of their (r, r)."""

    def __init__(self, dot_zero, tol2, exact: bool, max_iter: int):
        k = dot_zero.shape[0]
        self.exact, self.max_iter = exact, max_iter
        self.thresh = dot_zero * tol2                       # solver.c:86
        # read once: the host repeats the device's float32 comparison
        self.thresh_host = None if exact else self.thresh.cpu().numpy()
        self.ones = torch.ones(k, dtype=dot_zero.dtype,
                               device=dot_zero.device)
        self.n_iter = np.zeros(k, np.int32)
        self.hist = []
        self.it = 0

    def active(self, dot_r):
        """(active lanes as a float [k] on the device, or None when every
        lane has stopped or max_iter is reached)."""
        if self.it >= self.max_iter:
            return None
        if self.exact:          # tol = 0: every lane, every iteration
            self.n_iter += 1
            return self.ones
        act = dot_r.cpu().numpy() > self.thresh_host      # the one read
        if not act.any():
            return None
        self.n_iter += act
        return (dot_r > self.thresh).to(dot_r.dtype)

    def record(self, ab, dot_new):
        self.hist.append(torch.where(ab, dot_new, torch.nan))
        self.it += 1

    def result(self, X, B, dot_r, dot_zero, tol2, spmv,
               reduce=None) -> SolveResult:
        """The SolveResult at exit; the true residuals from spmv(X), their
        per-lane dots completed by reduce (over a row group:
        solvers/batched_dist.py)."""
        k = dot_zero.shape[0]
        history = torch.full((k, self.max_iter), float("nan"),
                             dtype=dot_zero.dtype, device=dot_zero.device)
        if self.hist:
            history[:, :len(self.hist)] = torch.sqrt(
                torch.stack(self.hist, 1) / dot_zero[:, None])
        R_true = B - spmv(X)
        rr = _dot(R_true, R_true)
        true_relres = torch.sqrt((rr if reduce is None else reduce(rr))
                                 / dot_zero)
        tol = torch.sqrt(tol2)
        return SolveResult(
            x=X, n_iter=torch.as_tensor(self.n_iter),
            final_relres=torch.sqrt(dot_r / dot_zero), history=history,
            converged=(dot_r <= self.thresh)
            & (true_relres <= 100.0 * tol),
            true_relres=true_relres)


def bicgstab_batched_fully_fused(A, B, X0, cfg) -> SolveResult:
    """Three fused passes per iteration over all k lanes; the p update is
    deferred to the next iteration's K1b (beta = omega = 0 and p = s = 0
    on the first), exactly like the single-lane fused driver
    (ops/cuda_fused_classic.bicgstab_fused, solver.c:117-119). Frozen
    lanes are masked inside K1b and K3b by the active flag; K2b runs them
    with alpha = 0, so that q = r exactly. r0 and the true residual take
    the batched SpMV."""
    vals, offsets = A.vals, A.offsets
    tol2, exact, _ = start(B, cfg)

    def spmv(Xs):
        return batched_dia_spmv(vals, offsets, Xs)

    R0 = B - spmv(X0)                                   # solver.c:74-75
    R_hat = R0                                          # solver.c:76
    rTr0 = _dot(R0, R0)                                 # solver.c:78-80
    dot_zero = rTr0
    lanes = _Lanes(dot_zero, tol2, exact, cfg.max_iter)
    zk = torch.zeros_like(rTr0)
    X, R, P, S = X0, R0, torch.zeros_like(R0), torch.zeros_like(R0)
    beta = omega = zk
    rTr = dot_r = rTr0
    while (a := lanes.active(dot_r)) is not None:
        ab = a > 0.5
        P2, S2, rhTs = fused_k1b(vals, R, P, S, R_hat, (beta, omega, a),
                                 offsets)               # solver.c:88-91
        # a frozen lane's recurrences may be inf or NaN; the kernels mask
        # its vectors, and K2b needs alpha = 0 to give q = r
        alpha = torch.where(ab, rTr / rhTs, zk)         # solver.c:93
        Q, Y, qTy, yTy = fused_k2b(vals, R, S2, (alpha,),
                                   offsets)             # solver.c:94-102
        omega2 = torch.where(ab, qTy / yTy, zk)         # solver.c:104
        X, R, dot_new, rTr_new = fused_k3b(X, P2, Q, Y, R_hat,
                                           (alpha, omega2, a))  # :105-114
        beta = torch.where(ab, (alpha / omega2) * (rTr_new / rTr),
                           beta)                        # solver.c:116
        omega = torch.where(ab, omega2, omega)
        rTr = torch.where(ab, rTr_new, rTr)
        dot_r = torch.where(ab, dot_new, dot_r)
        P, S = P2, S2
        lanes.record(ab, dot_new)
    return lanes.result(X, B, dot_r, dot_zero, tol2, spmv)
