"""Padded ELL (ITPACK) layout (counterpart of mpi_bicgstab_tpu/ops/ell.py).

Slab-major: cols[w, i], vals[w, i] hold row i's w-th stored entry (cols
padded with 0, vals with 0.0). Rows longer than the width spill into a
COO tail. The SpMV (ops/spmv.py) is `width` gathers and multiply-adds.
With dtype="df32" vals and tail_vals are double-float pairs
(ops/precision.DF), split from float64.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpi_bicgstab_tpu_torch.ops.dia import (host_dtype, host_values,
                                            is_df32)
from mpi_bicgstab_tpu_torch.ops.precision import df_from_f64
from mpi_bicgstab_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """Slab-major ELL sparse matrix plus a COO tail.

    cols: int32 [width, n_rows], 0 where padded (the matching vals entry
          is 0.0, so the gather of x[0] contributes nothing).
    vals: [width, n_rows] (a DF pair for df32)
    tail_*: overflow entries of rows longer than `width`; padding has
          val 0.0, row n_rows-1, col 0.
    """

    cols: torch.Tensor
    vals: torch.Tensor
    tail_rows: torch.Tensor  # int32 [tail_size]
    tail_cols: torch.Tensor  # int32 [tail_size]
    tail_vals: torch.Tensor  # [tail_size]
    n_rows: int
    n_cols: int

    @property
    def width(self) -> int:
        return self.cols.shape[0]

    @property
    def tail_size(self) -> int:
        return self.tail_vals.shape[0]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    @property
    def nnz_stored(self) -> int:
        """Dense storage footprint (includes padding)."""
        return self.cols.numel() + self.tail_size


def csr_to_ell(csr, width: int | None = None, tail_pad: int = 0,
               dtype=None, device="cuda") -> EllMatrix:
    """Build the slab-major ELL layout from a host CSRMatrix.

    width: slab count per row (default: the longest row, so the tail is
        empty). Longer rows spill to the tail.
    tail_pad: round the tail up to at least this size.
    """
    dev = resolve_device(device)
    lengths = csr.row_lengths
    n_rows, n_cols = csr.shape
    max_len = int(lengths.max()) if n_rows and lengths.size else 0
    W = max(max_len if width is None else int(width), 1)

    rows = np.repeat(np.arange(n_rows, dtype=np.int64), lengths)
    offs = np.arange(csr.nnz, dtype=np.int64) - csr.ptr[rows]

    vals_dtype = host_dtype(dtype, csr.val.dtype)
    cols = np.zeros((W, n_rows), dtype=np.int32)
    vals = np.zeros((W, n_rows), dtype=vals_dtype)
    in_ell = offs < W
    cols[offs[in_ell], rows[in_ell]] = csr.col[in_ell]
    vals[offs[in_ell], rows[in_ell]] = csr.val[in_ell]

    n_tail = int((~in_ell).sum())
    tail_size = max(n_tail, tail_pad)
    t_rows = np.full(tail_size, max(n_rows - 1, 0), dtype=np.int32)
    t_cols = np.zeros(tail_size, dtype=np.int32)
    t_vals = np.zeros(tail_size, dtype=vals_dtype)
    if n_tail:
        t_rows[:n_tail] = rows[~in_ell]
        t_cols[:n_tail] = csr.col[~in_ell]
        t_vals[:n_tail] = csr.val[~in_ell]
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    put_vals = (lambda a: df_from_f64(a, dev)) if is_df32(dtype) else put
    return EllMatrix(put(cols), put_vals(vals), put(t_rows), put(t_cols),
                     put_vals(t_vals), n_rows, n_cols)


def ell_to_dense(A: EllMatrix) -> np.ndarray:
    """The dense matrix A holds, slabs and tail added up (for tests; DF
    values as float64)."""
    cols = A.cols.cpu().numpy()
    vals = host_values(A.vals)
    d = np.zeros((A.n_rows, A.n_cols), dtype=vals.dtype)
    rows = np.broadcast_to(np.arange(A.n_rows), cols.shape)
    np.add.at(d, (rows.ravel(), cols.ravel()), vals.ravel())
    np.add.at(d, (A.tail_rows.cpu().numpy(), A.tail_cols.cpu().numpy()),
              host_values(A.tail_vals))
    return d
