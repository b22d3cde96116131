"""BiCGStab(l), polynomial-stabilised BiCGStab (Sleijpen & Fokkema, ETNA
1, 1993), beyond the reference (counterpart of
mpi_bicgstab_tpu/solvers/bicgstab_l.py).

BiCGStab's stabiliser is a degree-1 minimal-residual polynomial per step,
omega = (q,y)/(y,y). On a spectrum with large imaginary parts (skew-
dominant operators, strong convection) the best real degree-1 polynomial
cannot damp a conjugate pair and the classic family stagnates or
decouples from the true residual. BiCGStab(l) fits a degree-l polynomial
over l BiCG steps instead: l = 2 handles conjugate pairs.

One outer iteration is l classic-iteration equivalents (2l SpMVs): the
BiCG part grows the Krylov blocks R[0..l] and U[0..l] (kept as lists of
vectors), the MR part orthogonalises R[1..l] by modified Gram-Schmidt and
back-substitutes the gammas. n_iter counts classic equivalents (k += l),
so it can end anywhere up to max_iter + l - 1; the (r,r) of each outer
iteration goes to history slot k + l - 1, and is dropped when that slot
is past the end (the JAX package writes it with mode="drop"). The stop
test runs once per outer iteration; tol == 0 runs until k >= max_iter.
"""
from __future__ import annotations

from functools import partial

from mpi_bicgstab_tpu_torch.ops.blas import axpy
from mpi_bicgstab_tpu_torch.ops.precision import vones, vzeros_like
from mpi_bicgstab_tpu_torch.solvers.base import (SolveResult, finish,
                                                 maybe_print_residual, start)
from mpi_bicgstab_tpu_torch.utils.config import SolverConfig


def bicgstab_l(spmv, comm, b, x0, cfg: SolverConfig,
               l: int = 2) -> SolveResult:
    """BiCGStab(l) (Sleijpen-Fokkema algorithm 3.1)."""
    if l < 1:
        raise ValueError(f"l must be >= 1, got {l}")
    tol2, exact, alpha = start(b, cfg)                        # alpha = 0
    max_iter = cfg.max_iter

    r0 = b - spmv(x0)
    r_hat = r0
    rTr0 = comm.dot(r0, r0)
    dot_zero = dot_r = rTr0
    zeros = vzeros_like(b)
    R = [r0] + [zeros] * l
    U = [zeros] * (l + 1)
    rho0 = omega = vones((), alpha)                 # rho_0 = omega = 1
    x = x0
    hist = []
    thresh = None if exact else float(dot_zero * tol2)
    k = 0
    while k < max_iter and (exact or float(dot_r) > thresh):
        rho0 = -omega * rho0
        # ---- BiCG part: l steps growing the Krylov blocks ----
        for j in range(l):
            rho1 = comm.dot(R[j], r_hat)
            beta = alpha * (rho1 / rho0)
            rho0 = rho1
            for i in range(j + 1):
                U[i] = axpy(-beta, U[i], R[i])
            U[j + 1] = spmv(U[j])
            gamma_j = comm.dot(U[j + 1], r_hat)
            alpha = rho0 / gamma_j
            for i in range(j + 1):
                R[i] = axpy(-alpha, U[i + 1], R[i])
            R[j + 1] = spmv(R[j])
            x = axpy(alpha, U[0], x)
        # ---- MR part: modified Gram-Schmidt over R[1..l] ----
        tau = {}                 # tau[i, j], 1 <= i < j <= l
        sigma = [None] * (l + 1)
        gam_p = [None] * (l + 1)
        for j in range(1, l + 1):
            for i in range(1, j):
                t = comm.dot(R[j], R[i]) / sigma[i]
                tau[i, j] = t
                R[j] = axpy(-t, R[i], R[j])
            # sigma_j = (R_j, R_j) and (R_0, R_j) in one batched reduction
            sigma[j], g0j = comm.dots((R[j], R[j]), (R[0], R[j]))
            gam_p[j] = g0j / sigma[j]
        gam = [None] * (l + 1)
        gam[l] = omega = gam_p[l]
        for j in range(l - 1, 0, -1):
            acc = gam_p[j]
            for i in range(j + 1, l + 1):
                acc = acc - tau[j, i] * gam[i]
            gam[j] = acc
        gam_pp = [None] * l
        for j in range(1, l):
            acc = gam[j + 1]
            for i in range(j + 1, l):
                acc = acc + tau[j, i] * gam[i + 1]
            gam_pp[j] = acc
        # ---- update x, r, u from the MR combination ----
        x = axpy(gam[1], R[0], x)
        r_new = axpy(-gam_p[l], R[l], R[0])
        u_new = axpy(-gam[l], U[l], U[0])
        for j in range(1, l):
            u_new = axpy(-gam[j], U[j], u_new)
            x = axpy(gam_pp[j], R[j], x)
            r_new = axpy(-gam_p[j], R[j], r_new)
        R[0], U[0] = r_new, u_new
        dot_r = comm.dot(r_new, r_new)
        if k + l - 1 < max_iter:
            hist.append(dot_r)
        maybe_print_residual(cfg, k + l - 1, dot_r, dot_zero)
        k += l
    return finish(x, k, dot_r, dot_zero, tol2, hist, max_iter, spmv, comm,
                  b, step=l)


bicgstab_l2 = partial(bicgstab_l, l=2)
bicgstab_l4 = partial(bicgstab_l, l=4)
