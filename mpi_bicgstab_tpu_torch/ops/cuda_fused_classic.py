"""Fused classic-BiCGStab iteration, float32, DIA operators (counterpart
of mpi_bicgstab_tpu/ops/pallas_fused_classic.py; kernel source
csrc/fused_classic.cu).

Each iteration runs three passes (reference solver.c:86-119 update
order, the end-of-loop p update deferred into the next K1 — identical
expression, beta = omega = 0 on the first):

  K1:  p' = r + beta (p - omega s)   (recomputed at every neighbour)
       s' = A p'                     partial (r^, s')
  K2:  q  = r - alpha s'             (recomputed at every neighbour)
       y  = A q                      partials (q, y), (y, y)
  K3:  x' = x + alpha p' + omega q   pointwise
       r' = q - omega y              partials (r', r'), (r^, r')

Each of fused_k1 / fused_k2 / fused_k3 runs its plain PyTorch twin for
CPU tensors and launches the kernel for CUDA tensors, or raises; its
`.launches` counts kernel launches. The scalars are 0-d tensors on the
device of the vectors, passed to the kernels by pointer, and the dots
come back as 0-d tensors. The iteration count is the only value that
crosses to the host: the stop test reads dot_r once per iteration.

Unlike the JAX solver loop this one needs no padding to a tile grid and no
zero margins: the kernels skip out-of-range neighbours.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from mpi_bicgstab_tpu_torch.ops import _build
from mpi_bicgstab_tpu_torch.ops.cuda_spmv import (band_pass,
                                                  band_pass_argtypes,
                                                  check_cuda, check_scalars,
                                                  check_vectors, dia_spmv,
                                                  dia_spmv_plain,
                                                  partials_scratch,
                                                  stream_arg)

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_classic")
    sigs = {"mbt_fused_k1_f32": band_pass_argtypes(12),
            "mbt_fused_k2_f32": band_pass_argtypes(8),
            "mbt_fused_k3_f32": [ctypes.c_longlong] + [ctypes.c_void_p] * 12}
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def format_ok(A, dtype) -> bool:
    """Does the fused route take this operator at this solver dtype?
    (A DF pair, whose dtype is float32 too, takes the DF route.)"""
    from mpi_bicgstab_tpu_torch.ops.dia import DiaMatrix
    return (isinstance(A, DiaMatrix) and dtype == torch.float32
            and torch.is_tensor(A.vals) and A.vals.dtype == torch.float32
            and A.n_rows == A.n_cols and A.n_diags >= 1)


# --- K1 ---------------------------------------------------------------------

def fused_k1_plain(vals, r, p, s, r_hat, scalars, offsets):
    beta, omega = scalars
    p2 = r + beta * (p - omega * s)
    s2 = dia_spmv_plain(vals, offsets, p2)
    return p2, s2, torch.dot(r_hat, s2)


def fused_k1(vals, r, p, s, r_hat, scalars, offsets: tuple):
    """scalars = (beta, omega). Returns (p2, s2, rhTs) with
    p2 = r + beta (p - omega s), s2 = A p2, rhTs = (r_hat, s2)."""
    if r.device.type == "cpu":
        return fused_k1_plain(vals, r, p, s, r_hat, scalars, offsets)
    what = "fused_k1"
    sc = check_scalars(what, ("beta", "omega"), scalars)
    (p2, s2), dots = band_pass(_lib(), "mbt_fused_k1_f32", what, vals,
                               offsets, dict(r=r, p=p, s=s, r_hat=r_hat),
                               sc, 2, 1)
    fused_k1.launches += 1
    return p2, s2, dots[0]


fused_k1.launches = 0


# --- K2 ---------------------------------------------------------------------

def fused_k2_plain(vals, r, s2, scalars, offsets):
    (alpha,) = scalars
    q = r - alpha * s2
    y = dia_spmv_plain(vals, offsets, q)
    return q, y, torch.dot(q, y), torch.dot(y, y)


def fused_k2(vals, r, s2, scalars, offsets: tuple):
    """scalars = (alpha,). Returns (q, y, qTy, yTy) with q = r - alpha s2,
    y = A q."""
    if r.device.type == "cpu":
        return fused_k2_plain(vals, r, s2, scalars, offsets)
    what = "fused_k2"
    sc = check_scalars(what, ("alpha",), scalars)
    (q, y), dots = band_pass(_lib(), "mbt_fused_k2_f32", what, vals,
                             offsets, dict(r=r, s2=s2), sc, 2, 2)
    fused_k2.launches += 1
    return q, y, dots[0], dots[1]


fused_k2.launches = 0


# --- K3 ---------------------------------------------------------------------

def fused_k3_plain(x, p2, q, y, r_hat, scalars):
    alpha, omega = scalars
    x2 = x + alpha * p2 + omega * q
    r2 = q - omega * y
    return x2, r2, torch.dot(r2, r2), torch.dot(r_hat, r2)


def fused_k3(x, p2, q, y, r_hat, scalars):
    """scalars = (alpha, omega). Returns (x2, r2, dot_r, rTr_new) with
    x2 = x + alpha p2 + omega q, r2 = q - omega y, dot_r = (r2, r2),
    rTr_new = (r_hat, r2)."""
    if x.device.type == "cpu":
        return fused_k3_plain(x, p2, q, y, r_hat, scalars)
    what = "fused_k3"
    n = x.shape[0]
    sc = check_scalars(what, ("alpha", "omega"), scalars)
    check_vectors(what, n, x=x, p2=p2, q=q, y=y, r_hat=r_hat)
    check_cuda(what, torch.float32, x=x, p2=p2, q=q, y=y, r_hat=r_hat,
               **sc)
    x2, r2 = torch.empty_like(x), torch.empty_like(x)
    partials, dots = partials_scratch(x, 2)
    lib = _lib()
    err = lib.mbt_fused_k3_f32(
        n, x.data_ptr(), p2.data_ptr(), q.data_ptr(), y.data_ptr(),
        r_hat.data_ptr(), sc["alpha"].data_ptr(), sc["omega"].data_ptr(),
        x2.data_ptr(), r2.data_ptr(), partials.data_ptr(), dots.data_ptr(),
        stream_arg())
    _build.check(lib, err, what)
    fused_k3.launches += 1
    return x2, r2, dots[0], dots[1]


fused_k3.launches = 0


# --- the solver -------------------------------------------------------------

def bicgstab_fused(A, b, x0, cfg):
    """Classic BiCGStab, three fused passes per iteration (reference
    solver.c:35-146). Runs where A and b live."""
    from mpi_bicgstab_tpu_torch.parallel.comm import Comm
    from mpi_bicgstab_tpu_torch.solvers.base import finish, start

    vals, offsets = A.vals, A.offsets
    tol2, exact, zero = start(b, cfg)

    r0 = b - dia_spmv(vals, offsets, x0)                # solver.c:74-75
    rTr0 = torch.dot(r0, r0)                            # solver.c:78-80
    dot_zero = rTr0
    r_hat = r0                                          # solver.c:76
    x, r, p, s = x0, r0, torch.zeros_like(r0), torch.zeros_like(r0)
    beta = omega = zero
    rTr = dot_r = rTr0
    hist = []
    # solver.c:86; the stop test compares the float32 values exactly as
    # the JAX loop condition does (NaN stops the loop)
    thresh = None if exact else float(dot_zero * tol2)
    k = 0
    while k < cfg.max_iter and (exact or float(dot_r) > thresh):
        p2, s2, rhTs = fused_k1(vals, r, p, s, r_hat, (beta, omega),
                                offsets)
        alpha = rTr / rhTs                              # solver.c:93
        q, y, qTy, yTy = fused_k2(vals, r, s2, (alpha,), offsets)
        omega2 = qTy / yTy                              # solver.c:104
        x, r, dot_r, rTr_new = fused_k3(x, p2, q, y, r_hat,
                                        (alpha, omega2))
        beta = (alpha / omega2) * (rTr_new / rTr)       # solver.c:116
        p, s, omega, rTr = p2, s2, omega2, rTr_new
        hist.append(dot_r)
        k += 1
    return finish(x, k, dot_r, dot_zero, tol2, hist, cfg.max_iter,
                  lambda v: dia_spmv(vals, offsets, v), Comm(), b)
