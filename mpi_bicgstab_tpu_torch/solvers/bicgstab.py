"""The classic BiCGStab family, unfused (counterpart of
mpi_bicgstab_tpu/solvers/bicgstab.py):

  bicgstab          reference src/solver.c:35-146
  ca_bicgstab       reference src/solver.c:160-278 (communication-avoiding
                    rearrangement: two reduction points per iteration)
  pipe_bicgstab     reference src/solver.c:292-417 (pipelined, Cools &
                    Vanroose 2017: each SpMV sits between a dot batch and
                    its consumers)
  pipe_bicgstab_rr  reference src/solver.c:433-576 (pipelined with
                    periodic residual replacement)

and CLASSIC_SOLVERS, which also holds BiCGStab(l) (solvers/bicgstab_l.py).

This is the route for float64, for operators other than a DiaMatrix
(ELL, hybrid, a Chebyshev-preconditioned ops/cheby.ChebyOperator) and for
BiCGStab(l); the float32 DIA routes are the fused drivers of
ops/cuda_fused_classic.py, ops/cuda_fused_ca.py and ops/cuda_fused_pipe.py,
the df32 DIA routes those of ops/cuda_fused_classic_df.py,
ops/cuda_fused_ca_df.py and ops/cuda_fused_pipe_df.py. The same
code runs on double-float pairs (df32, ops/precision.DF): axpy and the
Comm dots take the DF forms, and float(dot_r) reads a pair's exact value.
pipe_bicgstab on DF pairs runs its iteration bodies as the two kernels
of ops/cuda_pipe_df_bodies.py (_pipe's fused_bodies), as the JAX package
does on its TPU.

Each solver takes spmv: x -> A@x, a Comm for the global dots, b, x0 and a
SolverConfig. The loop runs on the host; the scalars stay on the device
as 0-d tensors, and the only host synchronisation per iteration is the
stop test (none at all when tol == 0). The first-iteration reads of the
reference's uninitialised omega/s/z/v/p (solver.c:217-222,352-360) are
explicit zeros, which give the same first step because beta = 0.
"""
from __future__ import annotations

from mpi_bicgstab_tpu_torch.ops import cuda_pipe_df_bodies as bodies
from mpi_bicgstab_tpu_torch.ops.blas import axpy
from mpi_bicgstab_tpu_torch.ops.precision import is_df, vvalue, vzeros_like
from mpi_bicgstab_tpu_torch.solvers.base import (SolveResult, finish,
                                                 fold_beta_alpha, is_rr,
                                                 maybe_print_residual, start)
from mpi_bicgstab_tpu_torch.solvers.bicgstab_l import bicgstab_l2, bicgstab_l4
from mpi_bicgstab_tpu_torch.utils.config import SolverConfig


def bicgstab(spmv, comm, b, x0, cfg: SolverConfig) -> SolveResult:
    """Classic BiCGStab (reference solver.c:35-146).

    Per iteration: 2 SpMV and the reference's reduction points — (r^,s)
    alone, then (q,y)+(y,y) together, then (r,r)+(r^,r) together
    (solver.c:89-114)."""
    tol2, exact, _ = start(b, cfg)
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
        maybe_print_residual(cfg, k, dot_r, dot_zero)
        r, rTr = r_new, rTr_new
        k += 1
    return finish(x, k, dot_r, dot_zero, tol2, hist, cfg.max_iter, spmv,
                  comm, b)


def ca_bicgstab(spmv, comm, b, x0, cfg: SolverConfig) -> SolveResult:
    """Communication-avoiding BiCGStab (reference solver.c:160-278).

    2 SpMV per iteration and two reduction points: (q,y)+(y,y)
    (solver.c:227-230) and one batch of five, (r,r),(r^,r),(r^,w),
    (r^,s),(r^,z) (solver.c:236,240-247)."""
    tol2, exact, zero = start(b, cfg)
    r0 = b - spmv(x0)                                   # solver.c:200-201
    r_hat = r0                                          # solver.c:202
    w = spmv(r0)                                        # solver.c:205
    rTr0, rTw0 = comm.dots((r0, r0), (r0, w))           # solver.c:203-208
    alpha = rTr0 / rTw0                                 # solver.c:210
    beta = omega = zero                                 # solver.c:211
    p = s = z = vzeros_like(b)
    dot_zero = rTr = dot_r = rTr0
    x, r = x0, r0
    hist = []
    thresh = None if exact else float(dot_zero * tol2)
    k = 0
    while k < cfg.max_iter and (exact or float(dot_r) > thresh):  # :216
        p = axpy(beta, axpy(-omega, s, p), r)           # solver.c:217-219
        s = axpy(beta, axpy(-omega, z, s), w)           # solver.c:220-222
        z = spmv(s)                                     # solver.c:224
        q = axpy(-alpha, s, r)                          # solver.c:225
        y = axpy(-alpha, z, w)                          # solver.c:226
        qTy, yTy = comm.dots((q, y), (y, y))            # solver.c:227-230
        omega = qTy / yTy                               # solver.c:232
        x = axpy(omega, q, axpy(alpha, p, x))           # solver.c:233-234
        r = axpy(-omega, y, q)                          # solver.c:235
        w = spmv(r)                                     # solver.c:238
        dot_r, rTr_new, rhTw, rhTs, rhTz = comm.dots(
            (r, r), (r_hat, r), (r_hat, w), (r_hat, s),
            (r_hat, z))                                 # solver.c:236,240-247
        beta, alpha = fold_beta_alpha(alpha, omega, rTr, rTr_new, rhTw,
                                      rhTs, rhTz)       # solver.c:248-249
        hist.append(dot_r)
        maybe_print_residual(cfg, k, dot_r, dot_zero)
        rTr = rTr_new
        k += 1
    return finish(x, k, dot_r, dot_zero, tol2, hist, cfg.max_iter, spmv,
                  comm, b)


def _pipe(spmv, comm, b, x0, cfg: SolverConfig, rr: bool,
          fused_bodies: bool = False) -> SolveResult:
    """Pipelined BiCGStab, with residual replacement when rr is set.

    Each SpMV follows the dot batch whose latency it hides in the
    reference: v <- A z after (q,y),(y,y) (solver.c:363-367), t <- A w
    after the batch of five (solver.c:377-385). The JAX package orders
    them with comm.seq for its no-overlap mode (serialize_comm); one
    device has no reduction latency to hide, so the port has no seq.
    A replacement iteration (host test on the iteration counter, the
    JAX lax.cond) re-anchors s <- A p, z <- A s (solver.c:498-500) and
    the true residual r <- b - A x, w <- A r (solver.c:522-526).

    fused_bodies (DF pairs, no replacement) runs each iteration's updates
    and dot partials as the two fused passes of ops/cuda_pipe_df_bodies.py
    (JAX solvers/bicgstab._pipe_bicgstab_fused_bodies): the dots come
    back local and Comm completes them; spmv and the scalar recurrences
    stay outside. The kernels take any n, so nothing is padded (the JAX
    package pads to its 8192-row tile grid, with inert zero tails). Its
    stop test compares float32 values, as the JAX loop's does."""
    read = vvalue if fused_bodies else (lambda a: a)
    tol2, exact, zero = start(b, cfg)
    r0 = b - spmv(x0)                                   # solver.c:333-334
    r_hat = r0                                          # solver.c:335
    w = spmv(r0)                                        # solver.c:338
    t = spmv(w)                                         # solver.c:341
    rTr0, rTw0 = comm.dots((r0, r0), (r0, w))           # solver.c:336-343
    alpha = rTr0 / rTw0                                 # solver.c:345
    beta = omega = zero
    p = s = z = v = vzeros_like(b)
    dot_zero = rTr = dot_r = rTr0
    x, r = x0, r0
    hist = []
    thresh = None if exact else float(read(dot_zero) * tol2)
    k = 0
    while k < cfg.max_iter and (exact or float(read(dot_r)) > thresh):
        replace = rr and is_rr(k, cfg)                  # solver.c:351
        if fused_bodies:
            p, s, z, q, y, dots = bodies.fused_body_a(
                r, p, s, w, z, t, v, (alpha, beta, omega))  # :352-362
            qTy, yTy = comm.allreduce(dots)             # solver.c:363-364
        else:
            p = axpy(beta, axpy(-omega, s, p), r)       # solver.c:352-354
            if replace:
                s = spmv(p)                             # solver.c:499
                z = spmv(s)                             # solver.c:500
            else:   # s reads the old z: z is replaced after it
                s = axpy(beta, axpy(-omega, z, s), w)   # solver.c:355-357
                z = axpy(beta, axpy(-omega, v, z), t)   # solver.c:358-360
            q = axpy(-alpha, s, r)                      # solver.c:361
            y = axpy(-alpha, z, w)                      # solver.c:362
            qTy, yTy = comm.dots((q, y), (y, y))        # solver.c:363-364
        v = spmv(z)                                     # solver.c:365
        omega = qTy / yTy                               # solver.c:369
        if fused_bodies:
            x, r, w, dots = bodies.fused_body_b(
                x, p, q, y, t, v, r_hat, s, z, (alpha, omega))  # :370-375
            dot_r, rTr_new, rhTw, rhTs, rhTz = comm.allreduce(dots)
        else:
            x = axpy(omega, q, axpy(alpha, p, x))       # solver.c:370-371
            if replace:
                r = b - spmv(x)                         # solver.c:523-525
                w = spmv(r)                             # solver.c:526
            else:
                r = axpy(-omega, y, q)                  # solver.c:372
                w = axpy(-omega, axpy(-alpha, v, t), y)  # solver.c:374-375
            dot_r, rTr_new, rhTw, rhTs, rhTz = comm.dots(
                (r, r), (r_hat, r), (r_hat, w), (r_hat, s),
                (r_hat, z))                             # solver.c:373,377-380
        t = spmv(w)                                     # solver.c:381
        beta, alpha = fold_beta_alpha(alpha, omega, rTr, rTr_new, rhTw,
                                      rhTs, rhTz)       # solver.c:387-388
        hist.append(dot_r)
        maybe_print_residual(cfg, k, dot_r, dot_zero)
        rTr = rTr_new
        k += 1
    return finish(x, k, dot_r, dot_zero, tol2, hist, cfg.max_iter, spmv,
                  comm, b)


def pipe_bicgstab(spmv, comm, b, x0, cfg: SolverConfig) -> SolveResult:
    """Pipelined BiCGStab (reference solver.c:292-417). DF right-hand
    sides take the fused iteration bodies, as every DF b does in the JAX
    package on its TPU."""
    return _pipe(spmv, comm, b, x0, cfg, rr=False, fused_bodies=is_df(b))


def pipe_bicgstab_rr(spmv, comm, b, x0, cfg: SolverConfig) -> SolveResult:
    """Pipelined BiCGStab with residual replacement every cfg.krr
    iterations, at most cfg.nrr times (reference solver.c:433-576)."""
    return _pipe(spmv, comm, b, x0, cfg, rr=True)


CLASSIC_SOLVERS = {
    "bicgstab": bicgstab,
    "ca_bicgstab": ca_bicgstab,
    "pipe_bicgstab": pipe_bicgstab,
    "pipe_bicgstab_rr": pipe_bicgstab_rr,
}

# BiCGStab(l), beyond the reference
CLASSIC_SOLVERS["bicgstab_l2"] = bicgstab_l2
CLASSIC_SOLVERS["bicgstab_l4"] = bicgstab_l4
