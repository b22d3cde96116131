"""Fused classic-BiCGStab iteration in double-float (DF) arithmetic, DIA
operators (counterpart of mpi_bicgstab_tpu/ops/pallas_fused_classic_df.py;
kernel source csrc/fused_classic_df.cu, DF helpers csrc/df_core.cuh).

The iteration of ops/cuda_fused_classic.py with every vector, band value
and scalar a DF pair (ops/precision.DF): three passes, the DF DIA SpMV
inside K1 and K2, compensated DF dots. Each pass also computes, in its
finishing stage on the card, the scalar the next pass needs:

  K1:  p' = r + beta (p - omega s); s' = A p'      (r^, s');
                                                    alpha = rTr / (r^, s')
  K2:  q  = r - alpha s';           y  = A q       (q, y), (y, y);
                                                    omega = (q, y) / (y, y)
  K3:  x' = (x + alpha p') + omega q; r' = q - omega y
                                                    (r', r'), (r^, r');
                                   beta = (alpha / omega) ((r^, r') / rTr)

so that an iteration is six launches and its DF scalar algebra (four
df_div and a df_mul, some 200 tiny PyTorch launches if done with tensor
operations) never leaves the device. Each of fused_k1_df / fused_k2_df /
fused_k3_df runs its plain PyTorch twin for CPU tensors and launches the
kernel for CUDA tensors, or raises; `.launches` counts kernel launches.
The twins compute the same scalars with ops/precision.py. Vectors from a
kernel and its twin agree bit for bit; dots agree to ~1e-15 relative of
sum |u_i v_i| (the kernels sum their compensated partials in another
order than the twin's pairwise df_sum).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from mpi_bicgstab_tpu_torch.ops import _build
from mpi_bicgstab_tpu_torch.ops.cuda_spmv import (band_pass_argtypes,
                                                  check_scalars, df_pass,
                                                  dia_spmv_df,
                                                  dia_spmv_df_plain)
from mpi_bicgstab_tpu_torch.ops.precision import (df_div, df_dot, df_fma,
                                                  df_mul, is_df, vvalue,
                                                  vzeros_like)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_classic_df")
    sigs = {"mbt_fused_k1_df": band_pass_argtypes(24),
            "mbt_fused_k2_df": band_pass_argtypes(16),
            "mbt_fused_k3_df": [ctypes.c_longlong] + [ctypes.c_void_p] * 24}
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def format_ok(A, dtype) -> bool:
    """Does the fused DF route take this operator at this solver dtype?
    (A square DiaMatrix with DF values, the df32 config dtype float32.)"""
    from mpi_bicgstab_tpu_torch.ops.dia import DiaMatrix
    return (isinstance(A, DiaMatrix) and is_df(A.vals)
            and dtype == torch.float32 and A.n_rows == A.n_cols
            and A.n_diags >= 1)


# --- K1 ---------------------------------------------------------------------

def fused_k1_df_plain(vals, r, p, s, r_hat, scalars, offsets):
    beta, omega, rTr = scalars
    p2 = df_fma(r, beta, df_fma(p, -omega, s))
    s2 = dia_spmv_df_plain(vals, offsets, p2)
    rhTs = df_dot(r_hat, s2)
    return p2, s2, rhTs, df_div(rTr, rhTs)


def fused_k1_df(vals, r, p, s, r_hat, scalars, offsets: tuple):
    """scalars = (beta, omega, rTr). Returns (p2, s2, rhTs, alpha) with
    p2 = r + beta (p - omega s), s2 = A p2, rhTs = (r_hat, s2) and
    alpha = rTr / rhTs."""
    if r.device.type == "cpu":
        return fused_k1_df_plain(vals, r, p, s, r_hat, scalars, offsets)
    what = "fused_k1_df"
    (p2, s2), (rhTs,), (alpha,) = df_pass(
        _lib(), "mbt_fused_k1_df", what, vals, offsets,
        dict(r=r, p=p, s=s, r_hat=r_hat),
        check_scalars(what, ("beta", "omega", "rTr"), scalars), 2, 1)
    fused_k1_df.launches += 1
    return p2, s2, rhTs, alpha


fused_k1_df.launches = 0


# --- K2 ---------------------------------------------------------------------

def fused_k2_df_plain(vals, r, s2, scalars, offsets):
    (alpha,) = scalars
    q = df_fma(r, -alpha, s2)
    y = dia_spmv_df_plain(vals, offsets, q)
    qTy, yTy = df_dot(q, y), df_dot(y, y)
    return q, y, qTy, yTy, df_div(qTy, yTy)


def fused_k2_df(vals, r, s2, scalars, offsets: tuple):
    """scalars = (alpha,). Returns (q, y, qTy, yTy, omega) with
    q = r - alpha s2, y = A q and omega = qTy / yTy."""
    if r.device.type == "cpu":
        return fused_k2_df_plain(vals, r, s2, scalars, offsets)
    what = "fused_k2_df"
    (q, y), (qTy, yTy), (omega,) = df_pass(
        _lib(), "mbt_fused_k2_df", what, vals, offsets, dict(r=r, s2=s2),
        check_scalars(what, ("alpha",), scalars), 2, 2)
    fused_k2_df.launches += 1
    return q, y, qTy, yTy, omega


fused_k2_df.launches = 0


# --- K3 ---------------------------------------------------------------------

def fused_k3_df_plain(x, p2, q, y, r_hat, scalars):
    alpha, omega, rTr = scalars
    x2 = df_fma(df_fma(x, alpha, p2), omega, q)
    r2 = df_fma(q, -omega, y)
    dot_r, rTr_new = df_dot(r2, r2), df_dot(r_hat, r2)
    return (x2, r2, dot_r, rTr_new,
            df_mul(df_div(alpha, omega), df_div(rTr_new, rTr)))


def fused_k3_df(x, p2, q, y, r_hat, scalars):
    """scalars = (alpha, omega, rTr). Returns (x2, r2, dot_r, rTr_new,
    beta) with x2 = (x + alpha p2) + omega q, r2 = q - omega y,
    dot_r = (r2, r2), rTr_new = (r_hat, r2) and
    beta = (alpha / omega) (rTr_new / rTr)."""
    if x.device.type == "cpu":
        return fused_k3_df_plain(x, p2, q, y, r_hat, scalars)
    what = "fused_k3_df"
    (x2, r2), (dot_r, rTr_new), (beta,) = df_pass(
        _lib(), "mbt_fused_k3_df", what, None, None,
        dict(x=x, p2=p2, q=q, y=y, r_hat=r_hat),
        check_scalars(what, ("alpha", "omega", "rTr"), scalars), 2, 2)
    fused_k3_df.launches += 1
    return x2, r2, dot_r, rTr_new, beta


fused_k3_df.launches = 0


# --- the solver -------------------------------------------------------------

def bicgstab_fused_df(A, b, x0, cfg):
    """df32 classic BiCGStab, three fused DF passes per iteration
    (reference solver.c:35-146, the end-of-loop p update deferred into
    the next K1; JAX pallas_fused_classic_df.bicgstab_fused_df). The stop
    test compares float32 values, vvalue(dot_r) > vvalue(dot_zero) tol^2,
    with one host read per iteration and none at tol = 0. Runs where A
    and b live."""
    from mpi_bicgstab_tpu_torch.parallel.comm import Comm
    from mpi_bicgstab_tpu_torch.solvers.base import finish, start

    vals, offsets = A.vals, A.offsets

    def spmv(v):
        return dia_spmv_df(vals, offsets, v)

    tol2, exact, zero = start(b, cfg)
    r0 = b - spmv(x0)                                   # solver.c:74-75
    rTr0 = df_dot(r0, r0)                               # solver.c:78-80
    dot_zero = rTr0
    r_hat = r0                                          # solver.c:76
    x, r = x0, r0
    p = s = vzeros_like(r0)
    beta = omega = zero
    rTr = dot_r = rTr0
    hist = []
    thresh = None if exact else float(vvalue(dot_zero) * tol2)
    k = 0
    while k < cfg.max_iter and (exact or float(vvalue(dot_r)) > thresh):
        p, s, _, alpha = fused_k1_df(vals, r, p, s, r_hat,
                                     (beta, omega, rTr), offsets)
        q, y, _, _, omega = fused_k2_df(vals, r, s, (alpha,), offsets)
        x, r, dot_r, rTr_new, beta = fused_k3_df(x, p, q, y, r_hat,
                                                 (alpha, omega, rTr))
        rTr = rTr_new
        hist.append(dot_r)
        k += 1
    return finish(x, k, dot_r, dot_zero, tol2, hist, cfg.max_iter, spmv,
                  Comm(), b, f32_test=True)
