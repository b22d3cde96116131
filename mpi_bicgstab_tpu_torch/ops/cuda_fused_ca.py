"""Fused CA-BiCGStab iteration, float32, DIA operators (counterpart of
mpi_bicgstab_tpu/ops/pallas_fused_ca.py; kernel source csrc/fused_ca.cu).

The communication-avoiding rearrangement (reference solver.c:160-278)
runs as two passes per iteration, its two reduction points between them:

  K1:  p' = r + beta (p - omega s)
       s' = w + beta (s - omega z)    (recomputed at every neighbour)
       z' = A s'
       q  = r - alpha s',  y = w - alpha z'
                                      partials (q, y), (y, y)
  K2:  r' = q - omega y               (recomputed at every neighbour)
       w' = A r'
       x' = x + alpha p' + omega q
                                      partials (r',r'), (r^,r'), (r^,w'),
                                      (r^,s'), (r^,z')

fused_ca_k1 / fused_ca_k2 run their plain PyTorch twin for CPU tensors
and launch the kernel for CUDA tensors, or raise; `.launches` counts
kernel launches. Scalars are 0-d tensors on the vectors' device; the
stop test is the only value that crosses to the host, once per
iteration. No padding to a tile grid and no zero margins: the kernels
skip out-of-range neighbours. With `halo=` (an ops.cuda_spmv.Halo) each
pass runs its halo form (solvers/fused_dist.py).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from mpi_bicgstab_tpu_torch.ops import _build
from mpi_bicgstab_tpu_torch.ops.cuda_spmv import (Halo, band_pass,
                                                  band_pass_argtypes,
                                                  band_plain, center,
                                                  check_scalars, dia_spmv)
from mpi_bicgstab_tpu_torch.parallel.comm import Comm
from mpi_bicgstab_tpu_torch.solvers.base import (finish, fold_beta_alpha,
                                                 start)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_ca")
    for name, n_ptr in (("mbt_ca_k1_f32", 17), ("mbt_ca_k2_f32", 16)):
        fn = getattr(lib, name)
        fn.argtypes = band_pass_argtypes(n_ptr)
        fn.restype = ctypes.c_int
    return lib


# --- K1 ---------------------------------------------------------------------

def fused_ca_k1_plain(vals, r, p, s, w, z, scalars, offsets,
                      halo: Halo | None = None):
    alpha, beta, omega = scalars
    p2 = r + beta * (p - omega * s)
    s2 = w + beta * (s - omega * z)
    z2 = band_plain(vals, offsets, s2, halo)
    q = r - alpha * s2
    y = w - alpha * z2
    qc, yc = center(q, halo), center(y, halo)
    return p2, s2, z2, q, y, torch.dot(qc, yc), torch.dot(yc, yc)


def fused_ca_k1(vals, r, p, s, w, z, scalars, offsets: tuple,
                halo: Halo | None = None):
    """scalars = (alpha, beta, omega). Returns (p2, s2, z2, q, y, qTy,
    yTy) with p2 = r + beta (p - omega s), s2 = w + beta (s - omega z),
    z2 = A s2, q = r - alpha s2, y = w - alpha z2."""
    if r.device.type == "cpu":
        return fused_ca_k1_plain(vals, r, p, s, w, z, scalars, offsets,
                                 halo)
    what = "fused_ca_k1"
    sc = check_scalars(what, ("alpha", "beta", "omega"), scalars)
    outs, dots = band_pass(_lib(), "mbt_ca_k1_f32", what, vals, offsets,
                           dict(r=r, p=p, s=s, w=w, z=z), sc, 5, 2, halo)
    fused_ca_k1.launches += 1
    return (*outs, dots[0], dots[1])


fused_ca_k1.launches = 0


# --- K2 ---------------------------------------------------------------------

def fused_ca_k2_plain(vals, q, y, x, p2, r_hat, s2, z2, scalars, offsets,
                      halo: Halo | None = None):
    alpha, omega = scalars
    r2 = q - omega * y
    w2 = band_plain(vals, offsets, r2, halo)
    x2 = x + alpha * p2 + omega * q
    rh, rc, wc, sc, zc = (center(v, halo) for v in (r_hat, r2, w2, s2, z2))
    return (x2, r2, w2, torch.dot(rc, rc), torch.dot(rh, rc),
            torch.dot(rh, wc), torch.dot(rh, sc), torch.dot(rh, zc))


def fused_ca_k2(vals, q, y, x, p2, r_hat, s2, z2, scalars, offsets: tuple,
                halo: Halo | None = None):
    """scalars = (alpha, omega). Returns (x2, r2, w2, dot_r, rTr, rhTw,
    rhTs, rhTz) with r2 = q - omega y, w2 = A r2,
    x2 = x + alpha p2 + omega q and the five dots of r2, w2, s2, z2."""
    if q.device.type == "cpu":
        return fused_ca_k2_plain(vals, q, y, x, p2, r_hat, s2, z2, scalars,
                                 offsets, halo)
    what = "fused_ca_k2"
    sc = check_scalars(what, ("alpha", "omega"), scalars)
    outs, dots = band_pass(_lib(), "mbt_ca_k2_f32", what, vals, offsets,
                           dict(q=q, y=y, x=x, p2=p2, r_hat=r_hat, s2=s2,
                                z2=z2), sc, 3, 5, halo)
    fused_ca_k2.launches += 1
    return (*outs, *dots.unbind())


fused_ca_k2.launches = 0


# --- the solver -------------------------------------------------------------

def ca_bicgstab_fused(A, b, x0, cfg):
    """CA-BiCGStab, two fused passes per iteration (reference
    solver.c:160-278, same update order). Runs where A and b live."""
    vals, offsets = A.vals, A.offsets
    tol2, exact, zero = start(b, cfg)
    r0 = b - dia_spmv(vals, offsets, x0)                # solver.c:200-201
    r_hat = r0                                          # solver.c:202
    w = dia_spmv(vals, offsets, r0)                     # solver.c:205
    rTr0, rTw0 = torch.dot(r0, r0), torch.dot(r0, w)    # solver.c:203-208
    alpha = rTr0 / rTw0                                 # solver.c:210
    beta = omega = zero                                 # solver.c:211
    x, r = x0, r0
    p = s = z = torch.zeros_like(r0)
    dot_zero = rTr = dot_r = rTr0
    hist = []
    thresh = None if exact else float(dot_zero * tol2)
    k = 0
    while k < cfg.max_iter and (exact or float(dot_r) > thresh):  # :216
        p, s, z, q, y, qTy, yTy = fused_ca_k1(
            vals, r, p, s, w, z, (alpha, beta, omega), offsets)
        omega = qTy / yTy                               # solver.c:232
        x, r, w, dot_r, rTr_new, rhTw, rhTs, rhTz = fused_ca_k2(
            vals, q, y, x, p, r_hat, s, z, (alpha, omega), offsets)
        beta, alpha = fold_beta_alpha(alpha, omega, rTr, rTr_new, rhTw,
                                      rhTs, rhTz)       # solver.c:248-249
        hist.append(dot_r)
        rTr = rTr_new
        k += 1
    return finish(x, k, dot_r, dot_zero, tol2, hist, cfg.max_iter,
                  lambda v: dia_spmv(vals, offsets, v), Comm(), b)
