"""The shift-ladder axis (counterpart of mpi_bicgstab_tpu/parallel/sigma.py).

The shifted solvers address the [S, n] x_set / p_set state by ladder
index and scale it by mask-folded coefficient columns. On one sigma group
every shift is local and the module helpers below are plain indexing:
rows are read as copies and written in place (the solvers own their
state).

SigmaComm shards the ladder over a second axis of the process grid
(parallel/mesh.make_grid_mesh): each rank holds the [S/G, n_loc] slab of
its sigma group, and everything else (the [S] scalar recurrences, the
archives, the seed vectors, every dot) is replicated, so the seed-
switching logic runs unchanged and bit-identically on every group. Slab
updates take the local slice of the coefficient vectors (`loc`,
`coeff`); the seed row lives on one group, and `take_row` hands it to
all: the owner's row and the others' zeros, gathered over the sigma
subgroup and summed in rank order, which reproduces the row exactly. A
seed switch touches replicated state only and needs no communication.

Ladder indices given to SigmaComm are GLOBAL (Python ints: the port's
seed index lives on the host); the class maps them to the local slab row
and acts only on the owner.
"""
from __future__ import annotations

from mpi_bicgstab_tpu_torch.ops.precision import (DF, _as_df, df_add, is_df,
                                                  vwhere, vzeros)


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


class SigmaComm:
    """Shift-ladder axis helper: trivial (the module helpers) when groups
    is 1; otherwise `comm` (a parallel.comm.Comm over the sigma subgroup)
    joins the `groups` ranks that share this rank's rows, and its rank is
    this rank's sigma group."""

    def __init__(self, comm=None, groups: int = 1):
        if (comm is None) != (groups == 1):
            raise ValueError("comm and groups must agree: comm=None iff "
                             "groups == 1")
        if comm is not None and comm.size != groups:
            raise ValueError(f"the sigma communicator joins {comm.size} "
                             f"ranks, not {groups}")
        self.comm = comm
        self.groups = groups

    # -- geometry ---------------------------------------------------------
    def s_local(self, S: int) -> int:
        if S % self.groups:
            raise ValueError(f"sigma_len {S} not divisible by sigma groups "
                             f"{self.groups}")
        return S // self.groups

    def _offset(self, S: int) -> int:
        """This group's first global ladder index."""
        return 0 if self.comm is None else self.comm.rank * self.s_local(S)

    def _local(self, slab, i: int):
        """(local row, owned?) of global index i on this group's slab."""
        s_loc = slab.shape[0]
        off = self._offset(s_loc * self.groups)
        return i - off, off <= i < off + s_loc

    # -- replicated [S] -> local [S/G] ------------------------------------
    def loc(self, vec):
        """This group's slice of a replicated [S] (or DF [S]) vector."""
        if self.comm is None:
            return vec
        S = vec.shape[0]
        off = self._offset(S)
        return vec[off:off + self.s_local(S)]

    def coeff(self, mask, c, fill=0.0):
        """The local rows of coeff(mask, c, fill): [S/G, 1]."""
        return self.loc(vwhere(mask, c, fill))[:, None]

    # -- global-index row access on [S/G, n] slabs --------------------------
    def take_row(self, slab, i: int):
        """A copy of slab row i (global index), on every group."""
        if self.comm is None:
            return take_row(slab, i)
        li, own = self._local(slab, i)
        row = take_row(slab, li) if own else vzeros(tuple(slab.shape[1:]),
                                                   slab)
        return self.comm.sum_over_ranks(row)

    def row_set(self, slab, i: int, val):
        """slab[i] = val by global index, on the owner; returns the slab."""
        if self.comm is None:
            return row_set(slab, i, val)
        li, own = self._local(slab, i)
        return row_set(slab, li, val) if own else slab

    def row_add(self, slab, i: int, val):
        """slab[i] += val by global index, on the owner; returns the
        slab."""
        if self.comm is None:
            return row_add(slab, i, val)
        li, own = self._local(slab, i)
        return row_add(slab, li, val) if own else slab


def as_shift_comm(shift_comm) -> SigmaComm:
    """None -> the trivial communicator (one sigma group)."""
    return shift_comm if shift_comm is not None else SigmaComm()

