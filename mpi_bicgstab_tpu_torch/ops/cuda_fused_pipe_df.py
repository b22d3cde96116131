"""Fully fused pipelined-BiCGStab iteration phases in double-float (DF)
arithmetic, DIA operators (counterpart of
mpi_bicgstab_tpu/ops/pallas_fused_pipe_df2.py; kernel source
csrc/fused_pipe_df.cu, DF helpers csrc/df_core.cuh).

Each iteration (reference solver.c:351-388) is two phases. Unlike the
float32 drivers of ops/cuda_fused_pipe.py, each phase multiplies a
stored vector and forms the next SpMV input itself, as the JAX DF
phases do, so no vector operation runs between them and t lives only
within the iteration:

  phase A:  t = A w;  z' = t + beta (z - omega v)
            p' = r + beta (p - omega s);  s' = w + beta (s - omega z)
            q = r - alpha s';  y = w - alpha z'
                                 (q, y), (y, y);  omega' = (q, y) / (y, y)
  phase B:  v' = A z';  w' = y - omega' (t - alpha v')
            x' = (x + alpha p') + omega' q;  r' = q - omega' y
                                 (r',r'), (r^,r'), (r^,w'), (r^,s'),
                                 (r^,z');  beta', alpha'

Each phase's finishing stage computes the next scalars on the card, so
an iteration is four launches. fused_phase_a_df / fused_phase_b_df run
their plain PyTorch twin for CPU tensors and launch the kernel for CUDA
tensors, or raise; `.launches` counts kernel launches.
pipe_bicgstab_rr_fused_df runs its rare residual-replacement iterations
(chosen by a host test on the iteration counter) as five DF SpMV kernel
launches and DF tensor operations, and the fused phases on every other
iteration.
"""
from __future__ import annotations

import ctypes
import functools

from mpi_bicgstab_tpu_torch.ops import _build
from mpi_bicgstab_tpu_torch.ops.cuda_spmv import (band_pass_argtypes,
                                                  check_scalars, df_pass,
                                                  dia_spmv_df,
                                                  dia_spmv_df_plain)
from mpi_bicgstab_tpu_torch.ops.precision import (df_div, df_dot, df_fma,
                                                  vvalue, vzeros_like)
from mpi_bicgstab_tpu_torch.parallel.comm import Comm
from mpi_bicgstab_tpu_torch.solvers.base import (finish, fold_beta_alpha,
                                                 is_rr, start)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_pipe_df")
    for name in ("mbt_phase_a_df", "mbt_phase_b_df"):
        fn = getattr(lib, name)
        fn.argtypes = band_pass_argtypes(36)
        fn.restype = ctypes.c_int
    return lib


# --- phase A ----------------------------------------------------------------

def fused_phase_a_df_plain(vals, w, r, p, s, z, v, scalars, offsets):
    alpha, beta, omega = scalars
    t = dia_spmv_df_plain(vals, offsets, w)
    z2 = df_fma(t, beta, df_fma(z, -omega, v))
    p2 = df_fma(r, beta, df_fma(p, -omega, s))
    s2 = df_fma(w, beta, df_fma(s, -omega, z))
    q = df_fma(r, -alpha, s2)
    y = df_fma(w, -alpha, z2)
    qTy, yTy = df_dot(q, y), df_dot(y, y)
    return t, p2, s2, z2, q, y, qTy, yTy, df_div(qTy, yTy)


def fused_phase_a_df(vals, w, r, p, s, z, v, scalars, offsets: tuple):
    """scalars = (alpha, beta, omega). Returns (t, p2, s2, z2, q, y, qTy,
    yTy, omega2) with t = A w, z2 = t + beta (z - omega v), p2 = r +
    beta (p - omega s), s2 = w + beta (s - omega z), q = r - alpha s2,
    y = w - alpha z2 and omega2 = qTy / yTy."""
    if r.device.type == "cpu":
        return fused_phase_a_df_plain(vals, w, r, p, s, z, v, scalars,
                                      offsets)
    what = "fused_phase_a_df"
    outs, (qTy, yTy), (omega2,) = df_pass(
        _lib(), "mbt_phase_a_df", what, vals, offsets,
        dict(w=w, r=r, p=p, s=s, z=z, v=v),
        check_scalars(what, ("alpha", "beta", "omega"), scalars), 6, 2)
    fused_phase_a_df.launches += 1
    return (*outs, qTy, yTy, omega2)


fused_phase_a_df.launches = 0


# --- phase B ----------------------------------------------------------------

def fused_phase_b_df_plain(vals, z2, x, p2, q, y, t, r_hat, s2, scalars,
                           offsets):
    alpha, omega, rTr = scalars
    v2 = dia_spmv_df_plain(vals, offsets, z2)
    w2 = df_fma(y, -omega, df_fma(t, -alpha, v2))
    x2 = df_fma(df_fma(x, alpha, p2), omega, q)
    r2 = df_fma(q, -omega, y)
    dots = (df_dot(r2, r2), df_dot(r_hat, r2), df_dot(r_hat, w2),
            df_dot(r_hat, s2), df_dot(r_hat, z2))
    return (v2, x2, r2, w2, *dots, *fold_beta_alpha(alpha, omega, rTr,
                                                     *dots[1:]))


def fused_phase_b_df(vals, z2, x, p2, q, y, t, r_hat, s2, scalars,
                     offsets: tuple):
    """scalars = (alpha, omega, rTr). Returns (v2, x2, r2, w2, dot_r,
    rTr_new, rhTw, rhTs, rhTz, beta2, alpha2) with v2 = A z2, w2 = y -
    omega (t - alpha v2), x2 = (x + alpha p2) + omega q, r2 = q - omega y,
    the five dots of r2, w2, s2, z2 and (beta2, alpha2) =
    fold_beta_alpha of them."""
    if x.device.type == "cpu":
        return fused_phase_b_df_plain(vals, z2, x, p2, q, y, t, r_hat, s2,
                                      scalars, offsets)
    what = "fused_phase_b_df"
    outs, dots, folded = df_pass(
        _lib(), "mbt_phase_b_df", what, vals, offsets,
        dict(z2=z2, x=x, p2=p2, q=q, y=y, t=t, r_hat=r_hat, s2=s2),
        check_scalars(what, ("alpha", "omega", "rTr"), scalars), 4, 5, 2)
    fused_phase_b_df.launches += 1
    return (*outs, *dots, *folded)


fused_phase_b_df.launches = 0


# --- the solvers ------------------------------------------------------------

def _pipe_fused_df(A, b, x0, cfg, rr: bool):
    vals, offsets = A.vals, A.offsets

    def spmv(v):
        return dia_spmv_df(vals, offsets, v)

    tol2, exact, zero = start(b, cfg)
    r0 = b - spmv(x0)                                   # solver.c:333-334
    r_hat = r0                                          # solver.c:335
    w = spmv(r0)                                        # solver.c:338
    rTr0, rTw0 = df_dot(r0, r0), df_dot(r0, w)          # solver.c:336-343
    alpha = rTr0 / rTw0                                 # solver.c:345
    beta = omega = zero
    x, r = x0, r0
    p = s = z = v = vzeros_like(r0)
    dot_zero = rTr = dot_r = rTr0
    hist = []
    thresh = None if exact else float(vvalue(dot_zero) * tol2)
    k = 0
    while k < cfg.max_iter and (exact or float(vvalue(dot_r)) > thresh):
        if rr and is_rr(k, cfg):
            # replacement iteration (solver.c:494-539; JAX rr_body): s, z
            # and the true residual r, w re-anchored by DF SpMVs
            p = df_fma(r, beta, df_fma(p, -omega, s))   # solver.c:494-496
            s = spmv(p)                                 # solver.c:499
            z = spmv(s)                                 # solver.c:500
            q = df_fma(r, -alpha, s)                    # solver.c:510
            y = df_fma(w, -alpha, z)                    # solver.c:511
            qTy, yTy = df_dot(q, y), df_dot(y, y)
            v = spmv(z)                                 # solver.c:514
            omega = qTy / yTy                           # solver.c:518
            x = df_fma(df_fma(x, alpha, p), omega, q)   # solver.c:519-520
            r = b - spmv(x)                             # solver.c:523-525
            w = spmv(r)                                 # solver.c:526
            dot_r, rTr_new = df_dot(r, r), df_dot(r_hat, r)
            beta, alpha = fold_beta_alpha(
                alpha, omega, rTr, rTr_new, df_dot(r_hat, w),
                df_dot(r_hat, s), df_dot(r_hat, z))
            rTr = rTr_new
        else:
            t, p, s, z, q, y, _, _, omega = fused_phase_a_df(
                vals, w, r, p, s, z, v, (alpha, beta, omega), offsets)
            v, x, r, w, dot_r, rTr, _, _, _, beta, alpha = \
                fused_phase_b_df(vals, z, x, p, q, y, t, r_hat, s,
                                 (alpha, omega, rTr), offsets)
        hist.append(dot_r)
        k += 1
    return finish(x, k, dot_r, dot_zero, tol2, hist, cfg.max_iter, spmv,
                  Comm(), b, f32_test=True)


def pipe_bicgstab_fused_df(A, b, x0, cfg):
    """df32 pipelined BiCGStab, both phases fully fused (reference
    solver.c:292-417, same update order; JAX
    pallas_fused_pipe_df2.pipe_bicgstab_fused_df_full). The stop test
    compares float32 values, with one host read per iteration and none
    at tol = 0. Runs where A and b live."""
    return _pipe_fused_df(A, b, x0, cfg, rr=False)


def pipe_bicgstab_rr_fused_df(A, b, x0, cfg):
    """df32 pipelined BiCGStab with residual replacement every cfg.krr
    iterations, at most cfg.nrr times (reference solver.c:433-576; JAX
    pallas_fused_pipe_df2.pipe_bicgstab_rr_fused_df_full): the fused
    phases on every other iteration."""
    return _pipe_fused_df(A, b, x0, cfg, rr=True)
