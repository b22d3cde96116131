"""Host-side COO / CSR containers and conversions (NumPy); counterpart of
mpi_bicgstab_tpu/ops/sparse.py.

The reference's COO/CSR structs (matrix.h:10-26), the COO row sort
(matrix.c:125-183, here one stable argsort) and COO->CSR (coo2csr,
matrix.c:206-232). These are load-time host structures; the device
layouts are in ops/dia.py and ops/ell.py.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class COOMatrix:
    """COO triplet container (reference COO_Matrix, matrix.h:10-17)."""

    row: np.ndarray  # int64 [nnz]
    col: np.ndarray  # int64 [nnz]
    val: np.ndarray  # float [nnz]
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.val.size)

    def sorted_by_rows(self) -> "COOMatrix":
        """Stable sort by (row, col): one argsort of the fused key
        row*ncols + col, or a two-key lexsort when that key would
        overflow int64."""
        ncols = int(self.shape[1])
        if ncols and int(self.shape[0]) < (2 ** 62) // max(ncols, 1):
            key = self.row.astype(np.int64, copy=False) * np.int64(ncols) \
                + self.col
            order = np.argsort(key, kind="stable")
        else:
            order = np.lexsort((self.col, self.row))
        return COOMatrix(self.row[order], self.col[order], self.val[order],
                         self.shape)


@dataclasses.dataclass
class CSRMatrix:
    """CSR container (reference CSR_Matrix, matrix.h:19-26)."""

    ptr: np.ndarray  # int64 [nrows+1]
    col: np.ndarray  # int64 [nnz]
    val: np.ndarray  # float [nnz]
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.val.size)

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def row_lengths(self) -> np.ndarray:
        return np.diff(self.ptr)

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Host oracle SpMV (reference mult, matrix.c:498-516), returning
        a fresh y."""
        rows = np.repeat(np.arange(self.nrows), self.row_lengths)
        y = np.zeros(self.nrows, dtype=np.result_type(self.val, x))
        np.add.at(y, rows, self.val * x[self.col])
        return y


def coo_to_csr(coo: COOMatrix, sum_duplicates: bool = False) -> CSRMatrix:
    """COO -> CSR (reference coo2csr, matrix.c:206-232). Duplicates are
    kept as stored unless sum_duplicates collapses them."""
    c = coo.sorted_by_rows()
    row, col, val = c.row, c.col, c.val
    if sum_duplicates and val.size:
        key_same = (row[1:] == row[:-1]) & (col[1:] == col[:-1])
        if key_same.any():
            group = np.concatenate([[0], np.cumsum(~key_same)])
            ngroups = group[-1] + 1
            out_val = np.zeros(ngroups, dtype=val.dtype)
            np.add.at(out_val, group, val)
            first = np.concatenate([[True], ~key_same])
            row, col, val = row[first], col[first], out_val
    nrows = coo.shape[0]
    counts = np.bincount(row, minlength=nrows)
    ptr = np.zeros(nrows + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    return CSRMatrix(ptr, col.astype(np.int64), val, coo.shape)


def load_csr(path_or_file, dtype=np.float64,
             sum_duplicates: bool = False) -> CSRMatrix:
    """.mtx / .mtx.gz / .npz -> CSR (reference csr_load_matrix,
    matrix.c:234-242). .npz is the binary container the JAX package's
    save_csr writes (arrays ptr, col, val, shape)."""
    if isinstance(path_or_file, str) and path_or_file.endswith(".npz"):
        return load_csr_npz(path_or_file, dtype=dtype)
    from mpi_bicgstab_tpu_torch.io.mmio import read_matrix_market

    rows, cols, vals, shape = read_matrix_market(path_or_file, dtype=dtype)
    return coo_to_csr(COOMatrix(rows, cols, vals, shape),
                      sum_duplicates=sum_duplicates)


def load_csr_npz(path: str, dtype=np.float64) -> CSRMatrix:
    with np.load(path, allow_pickle=False) as z:
        try:
            ptr, col = z["ptr"], z["col"]
            val, shape = z["val"], z["shape"]
        except KeyError as e:
            raise ValueError(
                f"{path}: not a CSR container (missing {e}); expected "
                f"arrays ptr, col, val and shape") from e
    csr = CSRMatrix(ptr.astype(np.int64), col.astype(np.int64),
                    val.astype(dtype, copy=False),
                    (int(shape[0]), int(shape[1])))
    if csr.ptr.size != csr.shape[0] + 1 or int(csr.ptr[-1]) != csr.nnz:
        raise ValueError(f"{path}: inconsistent CSR arrays")
    return csr
