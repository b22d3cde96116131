"""SpMV over the windowed-ELL layout (counterpart of
mpi_bicgstab_tpu/ops/pallas_window_spmv.py: window_spmv, window_spmv_df).

y = A x reads the layout's row-compacted copy (ops/window_ell.py: rc_off,
rc_col, rc_val): on the card one kernel launch (ops/cuda_window_spmv.py,
csrc/window_spmv.cu), on the CPU its plain twin. Both walk each row's
list in order from acc = 0 and skip the empty slots: acc = acc + v *
x[col] (DF: acc = df_add(acc, df_mul(v, x[col]))), a rounded product and
a rounded sum, never contracted.

The list is the row's held slab entries in slab order, then its tail
entries in level order: the additions of the JAX kernel's slabs and of
the leveled tail, in their order, less the padded slots. A padded slot
adds v * xg = +-0 for finite xg, which leaves a float accumulator as it
was (it starts at +0, and round-to-nearest never makes it -0), and
leaves a normalised DF pair as it was. So for every finite x the result
is bit-equal to the padded twins below plus the leveled tail; where a
padded slot's column holds a NaN or an inf, the padded order gives NaN
and the compacted one does not read it.

The padded twins (window_slabs_plain, window_slabs_df_plain) and the
leveled tail (window_padded_plain) keep the JAX kernel's step-by-step
order; only the tests and chip_smoke.py call them, as the reference the
compacted SpMV is held to. The float tail adds level by level (within a
level a row appears at most once, so the order is fixed); the JAX float
path's one flat segment sum differs from it by rounding only.
"""
from __future__ import annotations

import torch

from mpi_bicgstab_tpu_torch.ops import cuda_window_spmv as cws
from mpi_bicgstab_tpu_torch.ops.precision import (DF, df_add, df_mul,
                                                  df_zeros, is_df)
from mpi_bicgstab_tpu_torch.ops.window_ell import (SLICE_ROWS,
                                                   WindowEllMatrix,
                                                   slab_columns)


def _row_slots(A: WindowEllMatrix):
    """Each row's first slot, [n_rows] int64, and its slice's width."""
    first = A.rc_off[:-1]
    width = (A.rc_off[1:] - first) // SLICE_ROWS
    lane = torch.arange(A.n_rows, device=first.device) % SLICE_ROWS
    return (first.repeat_interleave(SLICE_ROWS) + lane,
            width.repeat_interleave(SLICE_ROWS))


def _position(A: WindowEllMatrix, base, width, k: int):
    """Position k of every row's list: (column clamped into range, the
    mask of the rows that hold an entry there, the slot)."""
    slot = torch.where(k < width, base + SLICE_ROWS * k, 0)
    col = torch.where(k < width, A.rc_col[slot], -1)
    return col.clamp(min=0).long(), col >= 0, slot


def window_rows_plain(A: WindowEllMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x (float32 / float64) over the row-compacted copy: the
    kernel's twin."""
    base, width = _row_slots(A)
    acc = torch.zeros(A.n_rows, dtype=A.rc_val.dtype, device=x.device)
    for k in range(A.rc_width):
        col, held, slot = _position(A, base, width, k)
        acc = torch.where(held, acc + A.rc_val[slot] * x[col], acc)
    return acc


def window_rows_df_plain(A: WindowEllMatrix, x: DF) -> DF:
    """Double-float y = A x over the row-compacted copy: the DF kernel's
    twin."""
    base, width = _row_slots(A)
    acc = df_zeros((A.n_rows,), x.device)
    for k in range(A.rc_width):
        col, held, slot = _position(A, base, width, k)
        s = df_add(acc, df_mul(DF(A.rc_val.hi[slot], A.rc_val.lo[slot]),
                               DF(x.hi[col], x.lo[col])))
        acc = DF(torch.where(held, s.hi, acc.hi),
                 torch.where(held, s.lo, acc.lo))
    return acc


def window_slabs_plain(A: WindowEllMatrix, x: torch.Tensor) -> torch.Tensor:
    """The slab part of y = A x (float32 / float64) in the JAX kernel's
    order: every slot of every slab, padding included (a column >= n_cols
    reads 0, the JAX kernel's zero-padded x)."""
    acc = torch.zeros(A.vals.shape[1:], dtype=A.vals.dtype,
                      device=x.device)
    for w in range(A.width):
        col = slab_columns(A, w)
        ok = col < A.n_cols
        xg = torch.where(ok, x[col.clamp(max=A.n_cols - 1)],
                         torch.zeros((), dtype=x.dtype, device=x.device))
        acc = acc + A.vals[w] * xg
    return acc.reshape(A.n_rows)


def window_slabs_df_plain(A: WindowEllMatrix, x: DF) -> DF:
    """The slab part of y = A x in double-float, in the JAX DF kernel's
    order (as window_slabs_plain)."""
    acc = df_zeros(tuple(A.vals.hi.shape[1:]), x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    for w in range(A.width):
        col = slab_columns(A, w)
        ok = col < A.n_cols
        col = col.clamp(max=A.n_cols - 1)
        xg = DF(torch.where(ok, x.hi[col], zero),
                torch.where(ok, x.lo[col], zero))
        acc = df_add(acc, df_mul(A.vals[w], xg))
    return DF(acc.hi.reshape(A.n_rows), acc.lo.reshape(A.n_rows))


def window_padded_plain(A: WindowEllMatrix, x):
    """y = A x as the padded slabs plus the COO tail level by level (DF:
    one df_add per level on that level's rows, as the JAX DF path): the
    reference window_spmv is held to, bit for bit on finite x."""
    df = is_df(x)
    y = window_slabs_df_plain(A, x) if df else window_slabs_plain(A, x)
    for d, c in enumerate(A.tail_counts):
        if not c:
            continue
        rows, cols = A.tail_rows[d, :c], A.tail_cols[d, :c]
        if not df:
            y.index_add_(0, rows, A.tail_vals[d, :c] * x[cols])
            continue
        t = df_mul(DF(A.tail_vals.hi[d, :c], A.tail_vals.lo[d, :c]),
                   DF(x.hi[cols], x.lo[cols]))
        s = df_add(DF(y.hi[rows], y.lo[rows]), t)
        y.hi[rows] = s.hi
        y.lo[rows] = s.lo
    return y


def window_spmv(A: WindowEllMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x for float32 / float64 values; x: [n_cols] -> y: [n_rows].
    One kernel launch on the card, its twin on the CPU."""
    x = x.to(A.vals.dtype)
    if x.device.type == "cpu":
        return window_rows_plain(A, x)
    return cws.window_rows(A, x)


def window_spmv_df(A: WindowEllMatrix, x: DF) -> DF:
    """Double-float y = A x (A.vals and x DF pairs). One kernel launch on
    the card, its twin on the CPU."""
    if x.device.type == "cpu":
        return window_rows_df_plain(A, x)
    return cws.window_rows_df(A, x)
