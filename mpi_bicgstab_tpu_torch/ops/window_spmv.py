"""SpMV over the windowed-ELL layout (counterpart of
mpi_bicgstab_tpu/ops/pallas_window_spmv.py: window_spmv, window_spmv_df).

y = A x is the slab part, which the CUDA kernel computes on the card
(ops/cuda_window_spmv.py, csrc/window_spmv.cu) and its plain twin here
computes for CPU tensors, plus the COO tail in PyTorch on both devices.

The twins: for each slab w in order, xg = x[window_base[t] * 1024 +
sub_sel[w, t, i, lam] * 128 + lam] with lam = lane_idx[w, t, i, j] (0
for a column >= n_cols: the JAX kernel's zero-padded x), and
acc = acc + vals[w] * xg from acc = 0 (DF: acc = df_add(acc,
df_mul(vals[w], xg))), as the kernels and the JAX kernels accumulate.

The tail goes level by level (ops/window_ell.py): within a level a row
appears at most once, so each level's scatter only places values and
the order of the additions is fixed, on the card too (one index_add of
the whole float tail, as the JAX float path does, would sum colliding
rows with atomics in an order that changes from run to run). DF adds
each level to its rows with df_add, as the JAX DF path does. The float
result differs from the JAX flat sum by rounding only.
"""
from __future__ import annotations

import torch

from mpi_bicgstab_tpu_torch.ops import cuda_window_spmv as cws
from mpi_bicgstab_tpu_torch.ops.precision import DF, df_add, df_mul, df_zeros
from mpi_bicgstab_tpu_torch.ops.window_ell import WindowEllMatrix


def _columns(A: WindowEllMatrix, w: int):
    """Slab w's x column per slot, [T, 8, 128] int64, clamped into range,
    and the mask of the slots whose column lies in range."""
    lam = A.lane_idx[w].long()
    s = torch.gather(A.sub_sel[w].long(), -1, lam)
    col = A.window_base.long()[:, None, None] * 1024 + s * 128 + lam
    ok = col < A.n_cols
    return col.clamp(max=A.n_cols - 1), ok


def window_slabs_plain(A: WindowEllMatrix, x: torch.Tensor) -> torch.Tensor:
    """The slab part of y = A x (float32 / float64): the kernel's twin."""
    acc = torch.zeros(A.vals.shape[1:], dtype=A.vals.dtype,
                      device=x.device)
    for w in range(A.width):
        col, ok = _columns(A, w)
        xg = torch.where(ok, x[col], torch.zeros((), dtype=x.dtype,
                                                 device=x.device))
        acc = acc + A.vals[w] * xg
    return acc.reshape(A.n_rows)


def window_slabs_df_plain(A: WindowEllMatrix, x: DF) -> DF:
    """The slab part of y = A x in double-float: the DF kernel's twin."""
    acc = df_zeros(tuple(A.vals.hi.shape[1:]), x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    for w in range(A.width):
        col, ok = _columns(A, w)
        xg = DF(torch.where(ok, x.hi[col], zero),
                torch.where(ok, x.lo[col], zero))
        acc = df_add(acc, df_mul(A.vals[w], xg))
    return DF(acc.hi.reshape(A.n_rows), acc.lo.reshape(A.n_rows))


def _levels(A: WindowEllMatrix):
    """(rows, cols, level index) of each tail level's real entries."""
    for d, c in enumerate(A.tail_counts):
        if c:
            yield A.tail_rows[d, :c], A.tail_cols[d, :c], d, c


def window_spmv(A: WindowEllMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x for float32 / float64 values; x: [n_cols] -> y: [n_rows].
    The kernel on the card, its twin on the CPU; then the tail."""
    x = x.to(A.vals.dtype)
    y = (window_slabs_plain(A, x) if x.device.type == "cpu"
         else cws.window_slabs(A, x))
    for rows, cols, d, c in _levels(A):
        y.index_add_(0, rows, A.tail_vals[d, :c] * x[cols])
    return y


def window_spmv_df(A: WindowEllMatrix, x: DF) -> DF:
    """Double-float y = A x (A.vals and x DF pairs). The kernel on the
    card, its twin on the CPU; then the tail, one df_add per level on
    that level's rows."""
    y = (window_slabs_df_plain(A, x) if x.device.type == "cpu"
         else cws.window_slabs_df(A, x))
    for rows, cols, d, c in _levels(A):
        t = df_mul(DF(A.tail_vals.hi[d, :c], A.tail_vals.lo[d, :c]),
                   DF(x.hi[cols], x.lo[cols]))
        s = df_add(DF(y.hi[rows], y.lo[rows]), t)
        y.hi[rows] = s.hi
        y.lo[rows] = s.lo
    return y
