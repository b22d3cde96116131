"""ELL SpMV (counterpart of mpi_bicgstab_tpu/ops/spmv.py).

The JAX package leaves this gather SpMV, float and double-float, to XLA
rather than a Pallas kernel; here it is plain PyTorch gathers on both
devices. It is the reference's `mult` (matrix.c:498-516), returning a
fresh y instead of accumulating.
"""
from __future__ import annotations

import torch

from mpi_bicgstab_tpu_torch.ops.ell import EllMatrix
from mpi_bicgstab_tpu_torch.ops.precision import (DF, df_add, df_fma, df_mul,
                                                  df_zeros)


def ell_spmv(A: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x. x: [n_cols] -> y: [n_rows]; padded entries gather x[0]
    with a 0.0 coefficient, the tail is scattered with index_add."""
    acc = torch.zeros(A.n_rows, dtype=torch.promote_types(A.vals.dtype,
                                                          x.dtype),
                      device=x.device)
    for w in range(A.width):
        acc = acc + A.vals[w] * x[A.cols[w]]
    if A.tail_size:
        acc = acc.index_add(0, A.tail_rows, A.tail_vals * x[A.tail_cols])
    return acc


def ell_spmv_shifted(A: EllMatrix, x: torch.Tensor, sigma) -> torch.Tensor:
    """y = (A + sigma I) @ x, the shifted-system operator (reference: s <-
    A p then daxpy sigma p, shifted_solver.c:261-262); A square."""
    return ell_spmv(A, x) + sigma * x


def ell_spmv_df(A: EllMatrix, x: DF) -> DF:
    """Double-float y = A @ x: A.vals and x are DF pairs. The gathers act
    on hi and lo alike; the slabs accumulate with df_fma; the COO tail's
    products are scattered hi and lo apart and added with df_add (the
    tail is rare, so its uncompensated lo sum stays below DF
    resolution)."""
    acc = df_zeros(A.n_rows, x.device)
    for w in range(A.width):
        cols = A.cols[w]
        acc = df_fma(acc, A.vals[w], DF(x.hi[cols], x.lo[cols]))
    if A.tail_size:
        t = df_mul(A.tail_vals, DF(x.hi[A.tail_cols], x.lo[A.tail_cols]))
        z = torch.zeros_like(acc.hi)
        acc = df_add(acc, DF(z.index_add(0, A.tail_rows, t.hi),
                             z.index_add(0, A.tail_rows, t.lo)))
    return acc
