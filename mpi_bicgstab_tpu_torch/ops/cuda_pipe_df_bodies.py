"""The fused iteration bodies of df32 pipelined BiCGStab, without the
SpMVs (counterpart of mpi_bicgstab_tpu/ops/pallas_fused_pipe_df.py:
fused_body_a, fused_body_b; kernel source csrc/pipe_df_bodies.cu).

  body A:  p' = r + beta (p - omega s);  s' = w + beta (s - omega z)
           z' = t + beta (z - omega v);  q = r - alpha s';  y = w - alpha z'
                                          dots (q, y), (y, y)
  body B:  x' = (x + alpha p') + omega q;  r' = q - omega y
           w' = y - omega (t - alpha v')
                                          dots (r', r'), (r^, r'), (r^, w'),
                                          (r^, s'), (r^, z')

Every operand is a DF pair (ops/precision.DF). The dots come back local,
as a DF [2] / [5] for the caller's Comm to complete; nothing is folded.
These are the iteration of solvers/bicgstab.pipe_bicgstab for every DF
right-hand side off the fully fused DIA route (other layouts, Chebyshev
operators, out_iter), as the JAX package runs them on its TPU. Each
wrapper runs its plain twin for CPU tensors and launches the kernel for
CUDA tensors, or raises; `.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

from mpi_bicgstab_tpu_torch.ops import _build
from mpi_bicgstab_tpu_torch.ops.cuda_spmv import check_scalars, df_pass
from mpi_bicgstab_tpu_torch.ops.precision import df_dot, df_fma, df_stack


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("pipe_df_bodies")
    for name, n_ptr in (("mbt_pipe_df_body_a", 33),
                        ("mbt_pipe_df_body_b", 31)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_longlong] + [ctypes.c_void_p] * n_ptr
        fn.restype = ctypes.c_int
    return lib


def fused_body_a_plain(r, p, s, w, z, t, v, scalars):
    alpha, beta, omega = scalars
    p2 = df_fma(r, beta, df_fma(p, -omega, s))
    s2 = df_fma(w, beta, df_fma(s, -omega, z))
    z2 = df_fma(t, beta, df_fma(z, -omega, v))
    q = df_fma(r, -alpha, s2)
    y = df_fma(w, -alpha, z2)
    return p2, s2, z2, q, y, df_stack([df_dot(q, y), df_dot(y, y)])


def fused_body_a(r, p, s, w, z, t, v, scalars):
    """scalars = (alpha, beta, omega). Returns (p2, s2, z2, q, y, dots)
    with dots the DF [2] = (q, y), (y, y)."""
    if r.device.type == "cpu":
        return fused_body_a_plain(r, p, s, w, z, t, v, scalars)
    what = "fused_body_a"
    outs, dots, _ = df_pass(
        _lib(), "mbt_pipe_df_body_a", what, None, None,
        dict(r=r, p=p, s=s, w=w, z=z, t=t, v=v),
        check_scalars(what, ("alpha", "beta", "omega"), scalars), 5, 2, 0)
    fused_body_a.launches += 1
    return (*outs, dots)


fused_body_a.launches = 0


def fused_body_b_plain(x, p2, q, y, t, v2, r_hat, s2, z2, scalars):
    alpha, omega = scalars
    x2 = df_fma(df_fma(x, alpha, p2), omega, q)
    r2 = df_fma(q, -omega, y)
    w2 = df_fma(y, -omega, df_fma(t, -alpha, v2))
    return x2, r2, w2, df_stack([
        df_dot(r2, r2), df_dot(r_hat, r2), df_dot(r_hat, w2),
        df_dot(r_hat, s2), df_dot(r_hat, z2)])


def fused_body_b(x, p2, q, y, t, v2, r_hat, s2, z2, scalars):
    """scalars = (alpha, omega). Returns (x2, r2, w2, dots) with dots the
    DF [5] = (r2, r2), (r_hat, r2), (r_hat, w2), (r_hat, s2),
    (r_hat, z2)."""
    if x.device.type == "cpu":
        return fused_body_b_plain(x, p2, q, y, t, v2, r_hat, s2, z2,
                                  scalars)
    what = "fused_body_b"
    outs, dots, _ = df_pass(
        _lib(), "mbt_pipe_df_body_b", what, None, None,
        dict(x=x, p2=p2, q=q, y=y, t=t, v2=v2, r_hat=r_hat, s2=s2, z2=z2),
        check_scalars(what, ("alpha", "omega"), scalars), 3, 5, 0)
    fused_body_b.launches += 1
    return (*outs, dots)


fused_body_b.launches = 0
