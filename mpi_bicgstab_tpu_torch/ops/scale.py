"""Jacobi (diagonal) scaling as an exact problem transformation
(counterpart of mpi_bicgstab_tpu/ops/scale.py):

    A' = D^-1/2 A D^-1/2,  b' = D^-1/2 b,  solve A' y = b',
    x  = D^-1/2 y,         with D = |diag(A)|

which gives A' a unit |diagonal| and leaves every solver untouched, as
the RCM permutation does (ops/reorder.py); the two compose.

Classic family only: scaling turns A + sigma I into
D^-1/2 A D^-1/2 + sigma D^-1, which is no longer a shift of A', so the
CLI offers --scale on `solve` alone.

Known solution: after scaling, b' = A' (D^1/2 1), so the scaled system's
solution is D^1/2, not all-ones; drivers unscale x before any all-ones
check.
"""
from __future__ import annotations

import numpy as np

from mpi_bicgstab_tpu_torch.ops.sparse import CSRMatrix


def jacobi_scale(csr: CSRMatrix):
    """Returns (csr_scaled, d_invsqrt) with A' = D^-1/2 A D^-1/2.

    D = |diag(A)|; a zero/missing structural diagonal entry gets
    scale 1 for its row/column (no information to equilibrate with)."""
    n = csr.nrows
    rows = np.repeat(np.arange(n, dtype=np.int64), csr.row_lengths)
    diag = np.zeros(n)
    on_diag = rows == csr.col
    diag[rows[on_diag]] = csr.val[on_diag]
    absd = np.abs(diag)
    d_invsqrt = np.where(absd > 0, 1.0 / np.sqrt(np.maximum(absd, 1e-300)),
                         1.0)
    val = csr.val * d_invsqrt[rows] * d_invsqrt[csr.col]
    return CSRMatrix(csr.ptr, csr.col, val, csr.shape), d_invsqrt


def scale_rhs(b, d_invsqrt):
    """b' = D^-1/2 b."""
    return np.asarray(b) * d_invsqrt


def unscale_solution(y, d_invsqrt):
    """x = D^-1/2 y (solution of the original system)."""
    return np.asarray(y) * d_invsqrt
