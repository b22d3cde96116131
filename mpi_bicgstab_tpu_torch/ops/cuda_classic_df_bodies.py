"""The iteration bodies of df32 classic BiCGStab around an operator the
caller applies (kernel source csrc/classic_df_bodies.cu; no Pallas
counterpart: the JAX package's XLA fuses this loop's DF ops itself).

  [op]     s = op(p)
  pass A:  (r^, s);  alpha = rTr / (r^, s)            classic_df_a
  pass Q:  q = r - alpha s                            classic_df_q
  [op]     y = op(q)
  pass O:  (q, y), (y, y);  omega = (q, y) / (y, y)   classic_df_o
  pass X:  x' = (x + alpha p) + omega q;  r' = q - omega y
           (r', r'), (r^, r');
           beta = (alpha / omega) ((r^, r') / rTr)    kernel 11,
                                   ops/cuda_fused_classic_df.fused_k3_df
  pass P:  p' = r' + beta (p - omega s)               classic_df_p

Every operand is a DF pair (ops/precision.DF). A pass with dots returns
them as a DF [1] / [2] (the rank's own) and the scalar its finishing
stage folds from them on the card, so that on one device no DF scalar
operation runs on the host; in a row-partitioned solve the caller
completes the dots through its Comm and forms the scalar from those (the
folded one, of the rank's own dots, goes unused). These are the
iteration of solvers/bicgstab.bicgstab for every DF right-hand side off
the fully fused DIA route (other layouts, Chebyshev operators, out_iter,
serialize_comm, the distributed unfused route). Each wrapper runs its
plain twin for CPU tensors, which is the unfused solver's DF step with
the same operations in the same order, and launches the kernel for CUDA
tensors, or raises; `.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

from mpi_bicgstab_tpu_torch.ops import _build
from mpi_bicgstab_tpu_torch.ops.cuda_spmv import check_scalars, df_pass
from mpi_bicgstab_tpu_torch.ops.precision import (df_div, df_dot, df_fma,
                                                  df_stack)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("classic_df_bodies")
    for name, n_ptr in (("mbt_classic_df_p", 13), ("mbt_classic_df_a", 10),
                        ("mbt_classic_df_q", 9), ("mbt_classic_df_o", 8)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_longlong] + [ctypes.c_void_p] * n_ptr
        fn.restype = ctypes.c_int
    return lib


def classic_df_p_plain(r, p, s, scalars):
    beta, omega = scalars
    return df_fma(r, beta, df_fma(p, -omega, s))


def classic_df_p(r, p, s, scalars):
    """scalars = (beta, omega). Returns p2 = r + beta (p - omega s)."""
    if r.device.type == "cpu":
        return classic_df_p_plain(r, p, s, scalars)
    what = "classic_df_p"
    (p2,), _, _ = df_pass(
        _lib(), "mbt_classic_df_p", what, None, None, dict(r=r, p=p, s=s),
        check_scalars(what, ("beta", "omega"), scalars), 1, 0, 0)
    classic_df_p.launches += 1
    return p2


classic_df_p.launches = 0


def classic_df_a_plain(r_hat, s, scalars):
    (rTr,) = scalars
    dots = df_stack([df_dot(r_hat, s)])
    return dots, df_div(rTr, dots[0])


def classic_df_a(r_hat, s, scalars):
    """scalars = (rTr,). Returns (dots, alpha) with dots the DF [1] =
    (r_hat, s) and alpha = rTr / (r_hat, s)."""
    if s.device.type == "cpu":
        return classic_df_a_plain(r_hat, s, scalars)
    what = "classic_df_a"
    _, dots, (alpha,) = df_pass(
        _lib(), "mbt_classic_df_a", what, None, None, dict(r_hat=r_hat, s=s),
        check_scalars(what, ("rTr",), scalars), 0, 1)
    classic_df_a.launches += 1
    return dots, alpha


classic_df_a.launches = 0


def classic_df_q_plain(r, s, scalars):
    (alpha,) = scalars
    return df_fma(r, -alpha, s)


def classic_df_q(r, s, scalars):
    """scalars = (alpha,). Returns q = r - alpha s."""
    if r.device.type == "cpu":
        return classic_df_q_plain(r, s, scalars)
    what = "classic_df_q"
    (q,), _, _ = df_pass(
        _lib(), "mbt_classic_df_q", what, None, None, dict(r=r, s=s),
        check_scalars(what, ("alpha",), scalars), 1, 0, 0)
    classic_df_q.launches += 1
    return q


classic_df_q.launches = 0


def classic_df_o_plain(q, y):
    dots = df_stack([df_dot(q, y), df_dot(y, y)])
    return dots, df_div(dots[0], dots[1])


def classic_df_o(q, y):
    """Returns (dots, omega) with dots the DF [2] = (q, y), (y, y) and
    omega = (q, y) / (y, y)."""
    if q.device.type == "cpu":
        return classic_df_o_plain(q, y)
    what = "classic_df_o"
    _, dots, (omega,) = df_pass(
        _lib(), "mbt_classic_df_o", what, None, None, dict(q=q, y=y), {}, 0,
        2)
    classic_df_o.launches += 1
    return dots, omega


classic_df_o.launches = 0
