"""DIA (diagonal) device layout (counterpart of mpi_bicgstab_tpu/ops/dia.py).

vals[w, i] = A[i, i + offsets[w]], 0 where out of range or absent. A
shift y += v_o * x[i+o] needs no index in memory: DIA stores no integer
per nonzero, and the SpMV streams the band values once. The workload
class (PDE / transport operators such as SuiteSparse Transport) keeps
its nonzeros on a few dozen global diagonals; `analyze_diagonals`
measures that at load time and ops/layout.build_operator routes
between DIA, DIA + ELL remainder (hybrid) and ELL. With dtype="df32"
the band values are a double-float pair (ops/precision.DF), assembled in
float64 on the host and split.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpi_bicgstab_tpu_torch.ops import cuda_spmv
from mpi_bicgstab_tpu_torch.ops.precision import df_from_f64, is_df
from mpi_bicgstab_tpu_torch.utils.config import canon_dtype
from mpi_bicgstab_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DiaMatrix:
    """Square diagonal-format sparse matrix: vals is a [W, n] tensor and
    offsets a tuple of W Python ints."""

    vals: torch.Tensor         # [n_diags, n_rows]; a DF pair for df32
    offsets: tuple
    n_rows: int
    n_cols: int

    @property
    def n_diags(self) -> int:
        return len(self.offsets)

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device


def is_df32(dtype) -> bool:
    """Is `dtype` the double-float mode's name "df32"?"""
    return isinstance(dtype, str) and dtype == "df32"


def host_dtype(dtype, default) -> np.dtype:
    """NumPy dtype for host-side assembly: the torch/NumPy/str `dtype`,
    or `default` (the CSR's value dtype) when dtype is None; float64 for
    "df32", whose pairs are split from float64 values."""
    if dtype is None:
        return np.dtype(default)
    if is_df32(dtype):
        return np.dtype(np.float64)
    return np.dtype(str(canon_dtype(dtype)).removeprefix("torch."))


def analyze_diagonals(csr, max_diags: int = 64, min_fill: float = 0.02):
    """Pick the offsets worth storing as dense diagonals.

    Returns (offsets, coverage): offsets with at least min_fill * n
    entries, at most max_diags of them (largest population first), and
    the fraction of nnz they cover."""
    rows = np.repeat(np.arange(csr.nrows, dtype=np.int64), csr.row_lengths)
    offs = csr.col - rows
    uniq, counts = np.unique(offs, return_counts=True)
    order = np.argsort(-counts)
    uniq, counts = uniq[order], counts[order]
    keep = counts >= max(1, int(min_fill * csr.nrows))
    uniq, counts = uniq[keep][:max_diags], counts[keep][:max_diags]
    coverage = counts.sum() / max(csr.nnz, 1)
    return tuple(int(o) for o in np.sort(uniq)), float(coverage)


def csr_to_dia(csr, offsets, dtype=None, device="cuda"):
    """Extract `offsets` into a DiaMatrix on `device`; returns
    (dia, remainder_csr). remainder_csr holds every entry NOT on the
    chosen offsets (None if fully covered). Duplicate entries on a kept
    offset accumulate. dtype="df32" stores vals as a DF pair."""
    from mpi_bicgstab_tpu_torch.ops.sparse import COOMatrix, coo_to_csr

    dev = resolve_device(device)
    n = csr.nrows
    if csr.shape[0] != csr.shape[1]:
        raise ValueError("DIA layout requires a square matrix")
    offsets = tuple(int(o) for o in offsets)
    vals_dtype = host_dtype(dtype, csr.val.dtype)
    rows = np.repeat(np.arange(n, dtype=np.int64), csr.row_lengths)
    entry_off = csr.col - rows

    W = len(offsets)
    vals = np.zeros((max(W, 1), n), dtype=vals_dtype)
    slot = np.full(csr.nnz, -1, dtype=np.int64)
    for w, o in enumerate(offsets):
        slot[entry_off == o] = w
    on_dia = slot >= 0
    np.add.at(vals, (slot[on_dia], rows[on_dia]), csr.val[on_dia])

    remainder = None
    if (~on_dia).any():
        rem = COOMatrix(rows[~on_dia], csr.col[~on_dia],
                        csr.val[~on_dia], csr.shape)
        remainder = coo_to_csr(rem)
    if is_df32(dtype):
        vals_dev = df_from_f64(vals, dev)
    else:
        vals_dev = torch.from_numpy(vals).to(dev)
    return DiaMatrix(vals_dev, offsets, n, n), remainder


def dia_spmv(A: DiaMatrix, x):
    """y = A @ x: the CUDA kernel for tensors on the card, its plain
    PyTorch version for tensors on the CPU (ops/cuda_spmv.py); DF
    values take the DF SpMV."""
    if is_df(A.vals):
        return cuda_spmv.dia_spmv_df(A.vals, A.offsets, x)
    return cuda_spmv.dia_spmv(A.vals, A.offsets, x)


def dia_spmv_df(A: DiaMatrix, x):
    """Double-float y = A @ x in plain PyTorch on either device (the JAX
    package's dia_spmv_df): the twin of the DF SpMV kernel."""
    return cuda_spmv.dia_spmv_df_plain(A.vals, A.offsets, x)
