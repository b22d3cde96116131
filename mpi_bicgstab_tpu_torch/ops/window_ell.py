"""Windowed-ELL layout for unstructured matrices whose rows keep column
locality: FEM meshes, graphs with community structure, block-clustered
systems (counterpart of mpi_bicgstab_tpu/ops/window_ell.py; the same CSR
gives the same arrays, so a layout built by either package runs in the
other).

Rows go in tiles of 1024 (8 sublanes x 128 lanes: row r sits at lane
r % 128 of sublane (r // 128) % 8 of tile r // 1024). Each tile t gets a
1024-aligned column window (window_base[t], in blocks of 1024 columns,
chosen at build time); every stored entry's column lies in its tile's
window, and entries outside it spill to a COO tail. Entries are assigned
to slabs w so that within each (tile, sublane-row, slab) each row slot
and each lane class (column % 128) is used at most once; then

    x-column of slot (w, t, i, j) = window_base[t] * 1024
                                    + sub_sel[w, t, i, lane] * 128 + lane,
    lane = lane_idx[w, t, i, j]

is well defined (the TPU kernel resolves it with a sublane gather and a
lane gather, the only fast dynamic gathers Mosaic has). Over-width
entries (more than max_width slabs) spill to the tail too.

The tail is leveled by duplicate rank: level d holds each tail row's
d-th entry, so a row appears at most once per level.

The port adds a row-compacted copy of the same entries (SELL-32, derived
from the arrays above whenever a layout is constructed): rows in slices
of 32, each row's list its held slab entries in slab order, then its
tail entries in level order. The SpMV reads only that copy
(ops/window_spmv.py); the TPU's slab arrays stay for parity with the JAX
package and for convert.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpi_bicgstab_tpu_torch.ops.dia import (LayoutRefused, host_dtype,
                                            is_df32)
from mpi_bicgstab_tpu_torch.ops.precision import DF, df_from_f64, is_df
from mpi_bicgstab_tpu_torch.utils.config import canon_dtype
from mpi_bicgstab_tpu_torch.utils.device import resolve_device

ROWS_PER_TILE = 1024          # 8 sublanes x 128 lanes
WINDOW_COLS = 1024            # the window: 8 rows of 128 columns
MAX_TAIL_LEVELS = 64
SLICE_ROWS = 32               # rows per slice of the row-compacted copy


@dataclasses.dataclass(frozen=True)
class WindowEllMatrix:
    """Slab-major windowed ELL (the JAX package's fields, plus `device`).

    sub_sel:  int8 [W, T, 8, 128]: sub_sel[w, t, i, lane] is the window
              row (0-7) of the slot of (w, t, i) whose lane_idx is
              `lane`; arbitrary where no slot uses that lane
    lane_idx: int8 [W, T, 8, 128]: target lane (column % 128) per slot
    vals:     [W, T, 8, 128] (a DF pair for df32), 0 where padded
    window_base: int32 [T], each tile's window in blocks of 1024 columns
    tail_rows, tail_cols: int32 [L, cap]; tail_vals [L, cap]: the COO
              spill by duplicate rank (module doc), entries front-packed
              per level; padding has row n_rows - 1, col 0, val 0
    tail_counts: the real entries of each level (one per level)
    x_rows:   the [x_rows, 128] view of x that covers every window (the
              JAX kernel's static height; columns >= n_cols read as 0)

    Derived (init=False; every construction, dataclasses.replace too,
    derives them on the layout's device, _row_compacted):
    rc_off:   int64 [n_rows / 32 + 1], each slice's first slot (rc_off[-1]
              the slot count S)
    rc_col:   int32 [S], the x column of each slot; -1 for an empty slot
    rc_val:   [S] values in the layout's dtype (a DF pair for df32), 0 in
              an empty slot
    rc_width: the widest slice's width (a Python int)
    Slot (slice s, position k, lane l) holds position k of row 32 s + l's
    list at rc_off[s] + 32 k + l; each slice is as wide as its longest
    row. A slab slot is held when its value is nonzero (DF: hi != 0) and
    its column lies below n_cols; every counted tail entry is held. The
    padded arrays above stay on the device for parity with the JAX
    package and for convert: no SpMV on the card reads them.
    """

    sub_sel: torch.Tensor
    lane_idx: torch.Tensor
    vals: torch.Tensor
    window_base: torch.Tensor
    tail_rows: torch.Tensor
    tail_cols: torch.Tensor
    tail_vals: torch.Tensor
    n_rows: int
    n_cols: int
    width: int
    x_rows: int
    tail_counts: tuple = ()
    rc_off: torch.Tensor = dataclasses.field(init=False, repr=False)
    rc_col: torch.Tensor = dataclasses.field(init=False, repr=False)
    rc_val: torch.Tensor = dataclasses.field(init=False, repr=False)
    rc_width: int = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        if len(self.tail_counts) != self.tail_rows.shape[0]:
            raise ValueError(
                f"tail_counts has {len(self.tail_counts)} entries for "
                f"{self.tail_rows.shape[0]} tail levels (the SpMV adds "
                f"each level's counted entries)")
        if self.n_rows % SLICE_ROWS:
            raise ValueError(f"n_rows {self.n_rows} is not a multiple of "
                             f"{SLICE_ROWS}")
        for k, v in zip(("rc_off", "rc_col", "rc_val", "rc_width"),
                        _row_compacted(self), strict=True):
            object.__setattr__(self, k, v)

    @property
    def n_tiles(self) -> int:
        return self.window_base.shape[0]

    @property
    def tail_size(self) -> int:
        """Tail capacity (levels x cap, zero-padded)."""
        return int(np.prod(tuple(self.tail_vals.shape)))

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    @property
    def nnz_stored(self) -> int:
        return int(np.prod(tuple(self.vals.shape))) + self.tail_size


def slab_columns(A: WindowEllMatrix, w: int) -> torch.Tensor:
    """Slab w's x column per slot, [T, 8, 128] int64 (>= n_cols where a
    slot's window runs past the last column)."""
    lam = A.lane_idx[w].long()
    s = torch.gather(A.sub_sel[w].long(), -1, lam)
    return A.window_base.long()[:, None, None] * WINDOW_COLS + s * 128 + lam


def _row_compacted(A: WindowEllMatrix):
    """(rc_off, rc_col, rc_val, rc_width) of A (the class doc), with
    vectorised torch ops on A's device: row r's list is its held slab
    entries in slab order, then its tail entries in level order (level d
    holds the row's d-th tail entry: position slab count + d)."""
    n, W = A.n_rows, A.width
    dev = A.window_base.device
    df = is_df(A.vals)
    hi = A.vals.hi if df else A.vals
    cols = torch.stack([slab_columns(A, w).reshape(n) for w in range(W)])
    held = (hi.reshape(W, n) != 0) & (cols < A.n_cols)
    n_slab = held.sum(0)
    w_i, r_i = held.nonzero(as_tuple=True)
    k_slab = (held.cumsum(0) - 1)[w_i, r_i]
    L, cap = A.tail_rows.shape
    real = (torch.arange(cap, device=dev)[None, :] < torch.as_tensor(
        A.tail_counts, dtype=torch.long, device=dev).reshape(L, 1))
    t_rows = A.tail_rows[real].long()
    k_tail = n_slab[t_rows] + torch.arange(L, device=dev)[:, None].expand(
        L, cap)[real]
    length = n_slab.scatter_reduce(0, t_rows, k_tail + 1, "amax")
    width = length.view(-1, SLICE_ROWS).amax(1)
    rc_off = torch.cat([width.new_zeros(1),
                        torch.cumsum(width * SLICE_ROWS, 0)])
    S = int(rc_off[-1])
    rows = torch.cat([r_i, t_rows])
    slot = (rc_off[rows // SLICE_ROWS] + SLICE_ROWS
            * torch.cat([k_slab, k_tail]) + rows % SLICE_ROWS)
    rc_col = torch.full((S,), -1, dtype=torch.int32, device=dev)
    rc_col[slot] = torch.cat([cols[held], A.tail_cols[real].long()]).int()

    def place(slab, tail):
        out = torch.zeros(S, dtype=slab.dtype, device=dev)
        out[slot] = torch.cat([slab.reshape(W, n)[held], tail[real]])
        return out

    rc_val = (DF(place(A.vals.hi, A.tail_vals.hi),
                 place(A.vals.lo, A.tail_vals.lo)) if df
              else place(A.vals, A.tail_vals))
    return rc_off, rc_col, rc_val, int(width.max())


def _choose_windows(csr, n_tiles):
    """Each row tile's window in blocks of 1024 columns: the aligned
    window that holds the tile's median column."""
    n = csr.nrows
    bases = np.zeros(n_tiles, dtype=np.int64)
    max_base = max(-(-csr.shape[1] // WINDOW_COLS) - 1, 0)
    for t in range(n_tiles):
        lo, hi = csr.ptr[t * ROWS_PER_TILE], \
            csr.ptr[min((t + 1) * ROWS_PER_TILE, n)]
        cols = csr.col[lo:hi]
        if cols.size == 0:
            continue
        bases[t] = min(max(int(np.median(cols)) // WINDOW_COLS, 0),
                       max_base)
    return bases


def _edge_color(group, row_slot, lane_cls, eligible, max_width):
    """Greedy parallel edge colouring: per `group` (tile x sublane-row),
    colour the entries so that no two share (group, row_slot) or (group,
    lane_cls) within a colour. Each pass takes the first remaining entry
    per (group, row_slot), then drops lane-class conflicts. Returns the
    colour of each entry (-1 = spill)."""
    N = group.size
    color = np.full(N, -1, dtype=np.int64)
    gr = group * 128 + row_slot
    gl = group * 128 + lane_cls
    remaining = np.flatnonzero(eligible)
    remaining = remaining[np.argsort(gr[remaining], kind="stable")]
    for w in range(max_width):
        if remaining.size == 0:
            break
        keys = gr[remaining]
        first = np.r_[True, keys[1:] != keys[:-1]]
        cand = remaining[first]
        o2 = np.argsort(gl[cand], kind="stable")
        c2 = cand[o2]
        k2 = gl[c2]
        keep2 = np.r_[True, k2[1:] != k2[:-1]]
        chosen = c2[keep2]
        color[chosen] = w
        mask = np.ones(N, dtype=bool)
        mask[chosen] = False
        remaining = remaining[mask[remaining]]
    return color


def _tail_levels(rows, cols, vals, spill, n, vals_dtype):
    """The spilled entries as [L, cap] levels by duplicate rank within
    their row, and each level's count. Raises LayoutRefused (a
    ValueError) when a row spills more than MAX_TAIL_LEVELS entries."""
    sp_rows = rows[spill]
    order = np.argsort(sp_rows, kind="stable")
    rs = sp_rows[order]
    starts = np.r_[0, np.flatnonzero(np.diff(rs)) + 1]
    gid = np.zeros(rs.size, dtype=np.int64)
    gid[starts[1:]] = 1
    gid = np.cumsum(gid)
    rank = np.arange(rs.size) - starts[gid]
    n_levels = int(rank.max()) + 1 if rank.size else 0
    if n_levels > MAX_TAIL_LEVELS:
        raise LayoutRefused(
            f"a row has {n_levels} tail entries (> {MAX_TAIL_LEVELS}): "
            "too little window locality for this layout (use gather-ELL, "
            "format='ell')")
    counts = (np.bincount(rank, minlength=max(n_levels, 1))
              if rank.size else np.zeros(1, dtype=np.int64))
    cap = max(int(counts.max()), 1)
    t_rows = np.full((n_levels, cap), max(n - 1, 0), dtype=np.int32)
    t_cols = np.zeros((n_levels, cap), dtype=np.int32)
    t_vals = np.zeros((n_levels, cap), dtype=vals_dtype)
    sp_cols = cols[spill][order]
    sp_vals = vals[spill][order]
    for d in range(n_levels):
        sel = rank == d
        k = int(sel.sum())
        if k:
            t_rows[d, :k] = rs[sel]
            t_cols[d, :k] = sp_cols[sel]
            t_vals[d, :k] = sp_vals[sel]
    return t_rows, t_cols, t_vals, tuple(int(c) for c in counts[:n_levels])


def csr_to_window_ell(csr, max_width: int = 24, dtype=None,
                      window_base=None,
                      force_width: int | None = None,
                      force_x_rows: int | None = None,
                      device="cuda") -> WindowEllMatrix:
    """Build the windowed-ELL layout on `device` from a host CSRMatrix.

    Entries outside their tile's window, or beyond `max_width` slabs of
    their (tile, sublane-row, lane class), spill to the COO tail.
    window_base, force_width and force_x_rows fix the windows, the slab
    count and the x view's height (to stack shards of equal shapes).
    dtype="df32" stores vals and tail_vals as DF pairs split from
    float64."""
    dev = resolve_device(device)
    n, n_cols = csr.shape
    if n % ROWS_PER_TILE:
        raise ValueError(
            f"windowed-ELL needs n_rows % {ROWS_PER_TILE} == 0 (got "
            f"{n}); pad with models.problem.pad_csr_identity(csr, 1024)")
    n_tiles = n // ROWS_PER_TILE
    bases = (_choose_windows(csr, n_tiles) if window_base is None
             else np.asarray(window_base, np.int64))

    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.ptr))
    cols = csr.col
    vals = csr.val
    t_of = rows // ROWS_PER_TILE
    c_local = cols - bases[t_of] * WINDOW_COLS
    in_win = (c_local >= 0) & (c_local < WINDOW_COLS)

    # slab = colour of a bipartite edge colouring (row slot -> lane
    # class) per (tile, sublane-row); over-width entries spill
    sub_row = (rows // 128) % 8
    lane_cls = cols % 128
    rank = _edge_color(t_of * 8 + sub_row, rows % 128, lane_cls, in_win,
                       max_width)
    ok = in_win & (rank >= 0)
    W = int(rank[ok].max() + 1) if ok.any() else 1
    if force_width is not None:
        if W > force_width:
            raise ValueError(f"force_width {force_width} < needed {W}")
        W = force_width

    vals_dtype = host_dtype(dtype, vals.dtype)
    sub_sel = np.zeros((W, n_tiles, 8, 128), dtype=np.int8)
    lane_idx = np.zeros((W, n_tiles, 8, 128), dtype=np.int8)
    val_arr = np.zeros((W, n_tiles, 8, 128), dtype=vals_dtype)
    w_ok, t_ok, i_ok = rank[ok], t_of[ok], sub_row[ok]
    j_ok = rows[ok] % 128                  # the slot's own lane
    lam = lane_cls[ok]                     # the target lane
    # the column's window row goes AT the target lane: well defined
    # because lane classes are unique within (w, t, i)
    sub_sel[w_ok, t_ok, i_ok, lam] = (c_local[ok] // 128).astype(np.int8)
    lane_idx[w_ok, t_ok, i_ok, j_ok] = lam.astype(np.int8)
    val_arr[w_ok, t_ok, i_ok, j_ok] = vals[ok]

    t_rows, t_cols, t_vals, counts = _tail_levels(
        rows, cols, vals, ~ok, n, vals_dtype)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    put_v = (lambda a: df_from_f64(a, dev)) if is_df32(dtype) else put
    return WindowEllMatrix(
        sub_sel=put(sub_sel), lane_idx=put(lane_idx), vals=put_v(val_arr),
        window_base=put(bases.astype(np.int32)),
        tail_rows=put(t_rows), tail_cols=put(t_cols),
        tail_vals=put_v(t_vals), tail_counts=counts,
        n_rows=n, n_cols=n_cols, width=W,
        x_rows=force_x_rows if force_x_rows is not None else
        max(-(-n_cols // 128),
            (int(bases.max()) + 1) * (WINDOW_COLS // 128)))


def window_ell_with_values(A: WindowEllMatrix, dtype,
                           device="cuda") -> WindowEllMatrix:
    """The layout A (float64 values) with its values cast to dtype
    (float32, float64, or "df32" pairs split from float64) on `device`:
    what csr_to_window_ell(csr, dtype=dtype) builds from A's CSR, without
    a second host build."""
    dev = resolve_device(device)
    if A.vals.dtype != torch.float64 or is_df32(A.dtype):
        raise TypeError("window_ell_with_values takes float64 values")

    def cast(v):
        if is_df32(dtype):
            return df_from_f64(v.cpu().numpy(), dev)
        return v.to(device=dev, dtype=canon_dtype(dtype))

    move = {k: getattr(A, k).to(dev) for k in
            ("sub_sel", "lane_idx", "window_base", "tail_rows", "tail_cols")}
    return dataclasses.replace(A, vals=cast(A.vals),
                               tail_vals=cast(A.tail_vals), **move)


def window_ell_stats(csr) -> dict:
    """The fraction of nonzeros inside their tile's window (the 'auto'
    route's test; over-width spill is caught by the build's
    LayoutRefused in ops/layout.py)."""
    n = csr.nrows
    n_tiles = -(-n // ROWS_PER_TILE)
    bases = _choose_windows(csr, n_tiles)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.ptr))
    t_of = rows // ROWS_PER_TILE
    c_local = csr.col - bases[t_of] * WINDOW_COLS
    in_win = (c_local >= 0) & (c_local < WINDOW_COLS)
    frac = float(in_win.mean()) if rows.size else 1.0
    return {"window_frac": frac, "n_tiles": n_tiles}
