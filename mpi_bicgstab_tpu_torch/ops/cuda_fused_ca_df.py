"""Fused CA-BiCGStab iteration in double-float (DF) arithmetic, DIA
operators (counterpart of mpi_bicgstab_tpu/ops/pallas_fused_ca_df.py;
kernel source csrc/fused_ca_df.cu, DF helpers csrc/df_core.cuh).

The iteration of ops/cuda_fused_ca.py with every vector, band value and
scalar a DF pair (ops/precision.DF): two passes, the DF DIA SpMV inside
each, compensated DF dots, and each pass's finishing stage computing on
the card the scalars the next pass needs:

  K1:  p' = r + beta (p - omega s)
       s' = w + beta (s - omega z);  z' = A s'
       q  = r - alpha s';  y = w - alpha z'
                                     (q, y), (y, y);  omega' = (q,y)/(y,y)
  K2:  r' = q - omega' y;  w' = A r'
       x' = (x + alpha p') + omega' q
                                     (r',r'), (r^,r'), (r^,w'), (r^,s'),
                                     (r^,z');  beta', alpha'

so that an iteration is four launches and its DF scalar algebra never
leaves the device. fused_ca_k1_df / fused_ca_k2_df run their plain
PyTorch twin for CPU tensors and launch the kernel for CUDA tensors, or
raise; `.launches` counts kernel launches. The twins compute the same
scalars with ops/precision.py. Vectors from a kernel and its twin agree
bit for bit; dots agree to ~1e-15 relative of sum |u_i v_i|.
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
                                                 start)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_ca_df")
    for name in ("mbt_ca_k1_df", "mbt_ca_k2_df"):
        fn = getattr(lib, name)
        fn.argtypes = band_pass_argtypes(32)
        fn.restype = ctypes.c_int
    return lib


# --- K1 ---------------------------------------------------------------------

def fused_ca_k1_df_plain(vals, r, p, s, w, z, scalars, offsets):
    alpha, beta, omega = scalars
    p2 = df_fma(r, beta, df_fma(p, -omega, s))
    s2 = df_fma(w, beta, df_fma(s, -omega, z))
    z2 = dia_spmv_df_plain(vals, offsets, s2)
    q = df_fma(r, -alpha, s2)
    y = df_fma(w, -alpha, z2)
    qTy, yTy = df_dot(q, y), df_dot(y, y)
    return p2, s2, z2, q, y, qTy, yTy, df_div(qTy, yTy)


def fused_ca_k1_df(vals, r, p, s, w, z, scalars, offsets: tuple):
    """scalars = (alpha, beta, omega). Returns (p2, s2, z2, q, y, qTy,
    yTy, omega2) with p2 = r + beta (p - omega s), s2 = w + beta (s -
    omega z), z2 = A s2, q = r - alpha s2, y = w - alpha z2 and
    omega2 = qTy / yTy."""
    if r.device.type == "cpu":
        return fused_ca_k1_df_plain(vals, r, p, s, w, z, scalars, offsets)
    what = "fused_ca_k1_df"
    outs, (qTy, yTy), (omega2,) = df_pass(
        _lib(), "mbt_ca_k1_df", what, vals, offsets,
        dict(r=r, p=p, s=s, w=w, z=z),
        check_scalars(what, ("alpha", "beta", "omega"), scalars), 5, 2)
    fused_ca_k1_df.launches += 1
    return (*outs, qTy, yTy, omega2)


fused_ca_k1_df.launches = 0


# --- K2 ---------------------------------------------------------------------

def fused_ca_k2_df_plain(vals, q, y, x, p2, r_hat, s2, z2, scalars,
                         offsets):
    alpha, omega, rTr = scalars
    r2 = df_fma(q, -omega, y)
    w2 = dia_spmv_df_plain(vals, offsets, r2)
    x2 = df_fma(df_fma(x, alpha, p2), omega, q)
    dots = (df_dot(r2, r2), df_dot(r_hat, r2), df_dot(r_hat, w2),
            df_dot(r_hat, s2), df_dot(r_hat, z2))
    return (x2, r2, w2, *dots, *fold_beta_alpha(alpha, omega, rTr,
                                                 *dots[1:]))


def fused_ca_k2_df(vals, q, y, x, p2, r_hat, s2, z2, scalars,
                   offsets: tuple):
    """scalars = (alpha, omega, rTr). Returns (x2, r2, w2, dot_r,
    rTr_new, rhTw, rhTs, rhTz, beta2, alpha2) with r2 = q - omega y,
    w2 = A r2, x2 = (x + alpha p2) + omega q, the five dots of r2, w2,
    s2, z2 and (beta2, alpha2) = fold_beta_alpha of them."""
    if q.device.type == "cpu":
        return fused_ca_k2_df_plain(vals, q, y, x, p2, r_hat, s2, z2,
                                    scalars, offsets)
    what = "fused_ca_k2_df"
    outs, dots, folded = df_pass(
        _lib(), "mbt_ca_k2_df", what, vals, offsets,
        dict(q=q, y=y, x=x, p2=p2, r_hat=r_hat, s2=s2, z2=z2),
        check_scalars(what, ("alpha", "omega", "rTr"), scalars), 3, 5, 2)
    fused_ca_k2_df.launches += 1
    return (*outs, *dots, *folded)


fused_ca_k2_df.launches = 0


# --- the solver -------------------------------------------------------------

def ca_bicgstab_fused_df(A, b, x0, cfg):
    """df32 CA-BiCGStab, two fused DF passes per iteration (reference
    solver.c:160-278, same update order; JAX
    pallas_fused_ca_df.ca_bicgstab_fused_df). The stop test compares
    float32 values, vvalue(dot_r) > vvalue(dot_zero) tol^2, with one host
    read per iteration and none at tol = 0. Runs where A and b live."""
    vals, offsets = A.vals, A.offsets

    def spmv(v):
        return dia_spmv_df(vals, offsets, v)

    tol2, exact, zero = start(b, cfg)
    r0 = b - spmv(x0)                                   # solver.c:200-201
    r_hat = r0                                          # solver.c:202
    w = spmv(r0)                                        # solver.c:205
    rTr0, rTw0 = df_dot(r0, r0), df_dot(r0, w)          # solver.c:203-208
    alpha = rTr0 / rTw0                                 # solver.c:210
    beta = omega = zero                                 # solver.c:211
    x, r = x0, r0
    p = s = z = vzeros_like(r0)
    dot_zero = rTr = dot_r = rTr0
    hist = []
    thresh = None if exact else float(vvalue(dot_zero) * tol2)
    k = 0
    while k < cfg.max_iter and (exact or float(vvalue(dot_r)) > thresh):
        p, s, z, q, y, _, _, omega = fused_ca_k1_df(
            vals, r, p, s, w, z, (alpha, beta, omega), offsets)
        x, r, w, dot_r, rTr, _, _, _, beta, alpha = fused_ca_k2_df(
            vals, q, y, x, p, r_hat, s, z, (alpha, omega, rTr), offsets)
        hist.append(dot_r)
        k += 1
    return finish(x, k, dot_r, dot_zero, tol2, hist, cfg.max_iter, spmv,
                  Comm(), b, f32_test=True)
