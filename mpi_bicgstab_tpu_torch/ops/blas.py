"""BLAS-1 layer (counterpart of mpi_bicgstab_tpu/ops/blas.py; reference
vector.c:3-26: my_daxpy / my_ddot). Double-float pairs (df32,
ops/precision.DF) take the compensated DF forms."""
from __future__ import annotations

import torch

from mpi_bicgstab_tpu_torch.ops.precision import df_dot, df_fma, df_stack, is_df


def dot(u, v):
    """Local dot product as a 0-d tensor (reference my_ddot,
    vector.c:10-16); the compensated DF dot for DF operands."""
    if is_df(u) or is_df(v):
        return df_dot(u, v)
    return torch.dot(u, v)


def dots(*pairs):
    """Several dot products stacked into one length-k tensor (or pair)."""
    vals = [dot(u, v) for u, v in pairs]
    if any(is_df(x) for x in vals):
        return df_stack(vals)
    return torch.stack(vals)


def axpy(alpha, x, y):
    """y + alpha*x for a 0-d alpha (reference my_daxpy, vector.c:3-8):
    one fused op for tensors, df_fma(y, alpha, x) for DF operands (the
    JAX solvers' vfma)."""
    if is_df(alpha) or is_df(x) or is_df(y):
        return df_fma(y, alpha, x)
    return torch.addcmul(y, alpha, x)
