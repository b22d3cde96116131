"""Fused pipelined-BiCGStab iteration phases, float32, DIA operators
(counterpart of mpi_bicgstab_tpu/ops/pallas_fused_pipe.py; kernel source
csrc/fused_pipe.cu).

Each iteration (reference solver.c:351-388) has two SpMV-anchored
phases. Their SpMV inputs are formed before them with plain tensor
operations, where the JAX driver forms them outside its kernels:

  z' = t + beta (z - omega v)
  phase A:  v' = A z'
            p' = r + beta (p - omega s)
            s' = w + beta (s - omega z)     (the OLD z)
            q  = r - alpha s',  y = w - alpha z'
                                            partials (q, y), (y, y)
  w' = y - omega' (t - alpha v')
  phase B:  t' = A w'
            x' = x + alpha p' + omega' q
            r' = q - omega' y               partials (r',r'), (r^,r'),
                                            (r^,w'), (r^,s'), (r^,z')

fused_phase_a / fused_phase_b run their plain PyTorch twin for CPU
tensors and launch the kernel for CUDA tensors, or raise; `.launches`
counts kernel launches. pipe_bicgstab_rr_fused runs its rare
residual-replacement iterations (chosen by a host test on the iteration
counter) as six DIA SpMV kernel launches and tensor operations, and the
fused phases on every other iteration.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from mpi_bicgstab_tpu_torch.ops import _build
from mpi_bicgstab_tpu_torch.ops.blas import axpy
from mpi_bicgstab_tpu_torch.ops.cuda_spmv import (band_pass,
                                                  band_pass_argtypes,
                                                  check_scalars, dia_spmv,
                                                  dia_spmv_plain)
from mpi_bicgstab_tpu_torch.parallel.comm import Comm
from mpi_bicgstab_tpu_torch.solvers.base import (finish, fold_beta_alpha,
                                                 is_rr, start)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_pipe")
    for name, n_ptr in (("mbt_phase_a_f32", 18), ("mbt_phase_b_f32", 17)):
        fn = getattr(lib, name)
        fn.argtypes = band_pass_argtypes(n_ptr)
        fn.restype = ctypes.c_int
    return lib


# --- phase A ----------------------------------------------------------------

def fused_phase_a_plain(vals, z_new, r, p, s, w, z_old, scalars, offsets):
    alpha, beta, omega = scalars
    v2 = dia_spmv_plain(vals, offsets, z_new)
    p2 = r + beta * (p - omega * s)
    s2 = w + beta * (s - omega * z_old)
    q = r - alpha * s2
    y = w - alpha * z_new
    return v2, p2, s2, q, y, torch.dot(q, y), torch.dot(y, y)


def fused_phase_a(vals, z_new, r, p, s, w, z_old, scalars, offsets: tuple):
    """scalars = (alpha, beta, omega). Returns (v2, p2, s2, q, y, qTy,
    yTy) with v2 = A z_new, p2 = r + beta (p - omega s),
    s2 = w + beta (s - omega z_old), q = r - alpha s2,
    y = w - alpha z_new."""
    if r.device.type == "cpu":
        return fused_phase_a_plain(vals, z_new, r, p, s, w, z_old, scalars,
                                   offsets)
    what = "fused_phase_a"
    sc = check_scalars(what, ("alpha", "beta", "omega"), scalars)
    outs, dots = band_pass(_lib(), "mbt_phase_a_f32", what, vals, offsets,
                           dict(z_new=z_new, r=r, p=p, s=s, w=w,
                                z_old=z_old), sc, 5, 2)
    fused_phase_a.launches += 1
    return (*outs, dots[0], dots[1])


fused_phase_a.launches = 0


# --- phase B ----------------------------------------------------------------

def fused_phase_b_plain(vals, w_new, x, p2, q, y, r_hat, s2, z2, scalars,
                        offsets):
    alpha, omega = scalars
    t2 = dia_spmv_plain(vals, offsets, w_new)
    x2 = x + alpha * p2 + omega * q
    r2 = q - omega * y
    return (t2, x2, r2, torch.dot(r2, r2), torch.dot(r_hat, r2),
            torch.dot(r_hat, w_new), torch.dot(r_hat, s2),
            torch.dot(r_hat, z2))


def fused_phase_b(vals, w_new, x, p2, q, y, r_hat, s2, z2, scalars,
                  offsets: tuple):
    """scalars = (alpha, omega). Returns (t2, x2, r2, dot_r, rTr, rhTw,
    rhTs, rhTz) with t2 = A w_new, x2 = x + alpha p2 + omega q,
    r2 = q - omega y and the five dots of r2, w_new, s2, z2."""
    if x.device.type == "cpu":
        return fused_phase_b_plain(vals, w_new, x, p2, q, y, r_hat, s2, z2,
                                   scalars, offsets)
    what = "fused_phase_b"
    sc = check_scalars(what, ("alpha", "omega"), scalars)
    outs, dots = band_pass(_lib(), "mbt_phase_b_f32", what, vals, offsets,
                           dict(w_new=w_new, x=x, p2=p2, q=q, y=y,
                                r_hat=r_hat, s2=s2, z2=z2), sc, 3, 5)
    fused_phase_b.launches += 1
    return (*outs, *dots.unbind())


fused_phase_b.launches = 0


# --- the solvers ------------------------------------------------------------

def _pipe_fused(A, b, x0, cfg, rr: bool):
    vals, offsets = A.vals, A.offsets

    def spmv(v):
        return dia_spmv(vals, offsets, v)

    tol2, exact, zero = start(b, cfg)
    r0 = b - spmv(x0)                                   # solver.c:333-334
    r_hat = r0                                          # solver.c:335
    w = spmv(r0)                                        # solver.c:338
    t = spmv(w)                                         # solver.c:341
    rTr0, rTw0 = torch.dot(r0, r0), torch.dot(r0, w)    # solver.c:336-343
    alpha = rTr0 / rTw0                                 # solver.c:345
    beta = omega = zero
    x, r = x0, r0
    p = s = z = v = torch.zeros_like(r0)
    dot_zero = rTr = dot_r = rTr0
    hist = []
    thresh = None if exact else float(dot_zero * tol2)
    k = 0
    while k < cfg.max_iter and (exact or float(dot_r) > thresh):  # :351
        if rr and is_rr(k, cfg):
            # replacement iteration (solver.c:494-539): s, z and the
            # true residual r, w re-anchored by SpMVs
            p = axpy(beta, axpy(-omega, s, p), r)       # solver.c:494-496
            s = spmv(p)                                 # solver.c:499
            z = spmv(s)                                 # solver.c:500
            q = axpy(-alpha, s, r)                      # solver.c:510
            y = axpy(-alpha, z, w)                      # solver.c:511
            qTy, yTy = torch.dot(q, y), torch.dot(y, y)
            v = spmv(z)                                 # solver.c:514
            omega = qTy / yTy                           # solver.c:518
            x = axpy(omega, q, axpy(alpha, p, x))       # solver.c:519-520
            r = b - spmv(x)                             # solver.c:523-525
            w = spmv(r)                                 # solver.c:526
            dot_r, rTr_new, rhTw, rhTs, rhTz = (
                torch.dot(r, r), torch.dot(r_hat, r), torch.dot(r_hat, w),
                torch.dot(r_hat, s), torch.dot(r_hat, z))
            t = spmv(w)                                 # solver.c:539
        else:
            z_new = axpy(beta, axpy(-omega, v, z), t)   # solver.c:358-360
            v, p, s, q, y, qTy, yTy = fused_phase_a(
                vals, z_new, r, p, s, w, z, (alpha, beta, omega), offsets)
            z = z_new
            omega = qTy / yTy                           # solver.c:369
            w = axpy(-omega, axpy(-alpha, v, t), y)     # solver.c:374-375
            t, x, r, dot_r, rTr_new, rhTw, rhTs, rhTz = fused_phase_b(
                vals, w, x, p, q, y, r_hat, s, z, (alpha, omega), offsets)
        beta, alpha = fold_beta_alpha(alpha, omega, rTr, rTr_new, rhTw,
                                      rhTs, rhTz)       # solver.c:387-388
        hist.append(dot_r)
        rTr = rTr_new
        k += 1
    return finish(x, k, dot_r, dot_zero, tol2, hist, cfg.max_iter, spmv,
                  Comm(), b)


def pipe_bicgstab_fused(A, b, x0, cfg):
    """Pipelined BiCGStab, both phases fused (reference solver.c:292-417,
    same update order). Runs where A and b live."""
    return _pipe_fused(A, b, x0, cfg, rr=False)


def pipe_bicgstab_rr_fused(A, b, x0, cfg):
    """Pipelined BiCGStab with residual replacement every cfg.krr
    iterations, at most cfg.nrr times (reference solver.c:433-576): the
    fused phases on every other iteration."""
    return _pipe_fused(A, b, x0, cfg, rr=True)
