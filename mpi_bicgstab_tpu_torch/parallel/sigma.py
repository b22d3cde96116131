"""The shift-ladder axis (counterpart of mpi_bicgstab_tpu/parallel/sigma.py).

The shifted solvers address the [S, n] x_set / p_set state by ladder
index and scale it by mask-folded coefficient columns. The JAX package
can shard the ladder over a second mesh axis through its SigmaComm; that
layer is ROADMAP slice 8 (distributed). On one device every shift is
local, so these helpers are plain indexing. Rows are read as copies and
written in place: the solvers own their state.
"""
from __future__ import annotations

from mpi_bicgstab_tpu_torch.ops.precision import (DF, _as_df, df_add, is_df,
                                                  vwhere)


def coeff(mask, c, fill=0.0):
    """Mask-folded coefficient COLUMN [S, 1] for slab updates: rows outside
    `mask` get `fill` (0 for increments, 1 for the multiplicative term of
    affine replacements), as the fused shift update folds its mask."""
    return vwhere(mask, c, fill)[:, None]


def take_row(slab, i: int):
    """A copy of slab[i]: later in-place updates of the slab leave it as
    it was read."""
    row = slab[i]
    return DF(row.hi.clone(), row.lo.clone()) if is_df(row) else row.clone()


def row_set(slab, i: int, val):
    """slab[i] = val, in place; returns the slab."""
    if is_df(slab):
        val = _as_df(val, slab)
        slab.hi[i] = val.hi
        slab.lo[i] = val.lo
    else:
        slab[i] = val
    return slab


def row_add(slab, i: int, val):
    """slab[i] += val, in place; returns the slab."""
    if is_df(slab):
        return row_set(slab, i, df_add(slab[i], val))
    slab[i] += val
    return slab
