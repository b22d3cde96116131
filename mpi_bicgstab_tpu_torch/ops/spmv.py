"""ELL SpMV (counterpart of mpi_bicgstab_tpu/ops/spmv.py).

The JAX package leaves this gather SpMV to XLA rather than a Pallas
kernel; here it is plain PyTorch gathers. It is the reference's `mult`
(matrix.c:498-516), returning a fresh y instead of accumulating.
"""
from __future__ import annotations

import torch

from mpi_bicgstab_tpu_torch.ops.ell import EllMatrix


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
