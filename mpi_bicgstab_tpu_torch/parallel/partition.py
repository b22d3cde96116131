"""1-D row partitioning of a CSR matrix (counterpart of
mpi_bicgstab_tpu/parallel/partition.py), built on the host.

Layout strategy per shard mirrors ops/layout.py:

* DIA part (dominant diagonals): a shard's values are the row slice of
  the global [n_diags, n] diagonal array. The distributed SpMV needs a
  HALO of H = max|offset| (rounded up to 128) from each neighbour, two
  edge exchanges of H elements instead of the reference's full-vector
  MPI_Iallgatherv (matrix.c:432). A band wider than a shard uses gather
  mode (the whole iterate gathered).
* ELL remainder: the reference's diag/offd block split (matrix.c:248-
  257), a square local block with LOCAL column indices and an off-
  diagonal block with GLOBAL ones, multiplied against the gathered
  iterate. A purely unstructured matrix whose shards' columns cluster
  takes the windowed-ELL layout on each square diag block; one with no
  locality at all the butterfly layout on each shard's full row slab
  (all columns, over the gathered iterate).

The reference gives remainder rows to the first ranks (matrix.c:295-
298); the shards here are shape-identical, padded with identity rows
(padded right-hand side entries are 0 and stay 0).

PartitionedMatrix holds every shard's blocks stacked, as host (CPU)
tensors in the JAX package's array layout, so that every rank can be
handed the same object; `shard(rank, device)` puts one rank's blocks on
its device as the port's layouts (a window shard derives its row-
compacted copy and a butterfly shard routes its column table there).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from mpi_bicgstab_tpu_torch.models.problem import pad_csr_identity
from mpi_bicgstab_tpu_torch.ops import native_route
from mpi_bicgstab_tpu_torch.ops.dia import (analyze_diagonals, csr_to_dia,
                                            host_dtype, is_df32)
from mpi_bicgstab_tpu_torch.ops.ell import EllMatrix, csr_to_ell
from mpi_bicgstab_tpu_torch.ops.precision import DF, df_from_f64, is_df
from mpi_bicgstab_tpu_torch.ops.sparse import CSRMatrix

_ELL_FIELDS = ("diag_cols", "diag_vals", "diag_tail_rows", "diag_tail_cols",
               "diag_tail_vals", "offd_cols", "offd_vals", "offd_tail_rows",
               "offd_tail_cols", "offd_tail_vals")
_WIN_FIELDS = ("win_sub", "win_lane", "win_vals", "win_base",
               "win_tail_rows", "win_tail_cols", "win_tail_vals")
_BFLY_FIELDS = ("bf_k1_src", "bf_k1_sub", "bf_k1_lane", "bf_k2_sub",
                "bf_k2_lane", "bf_k3_sub", "bf_k3_lane", "bf_k3_vals",
                "bf_tail_rows", "bf_tail_cols", "bf_tail_vals")


@dataclasses.dataclass(frozen=True)
class PartitionedMatrix:
    """Stacked per-shard blocks (CPU tensors, DF pairs for df32); each
    part may be None.

    dia_vals:   [n_diags, n_global]; a shard's slice is its own rows
    ELL fields: slab arrays [width, n_global], tails [n_devices * tail]
                (LOCAL rows); diag_* with local, offd_* global columns
    win_*:      windowed-ELL diag blocks: [W, T_total, 8, 128] tiles,
                win_base [T_total], tails [levels, n_devices * cap]
                (local rows and columns); win_tail_counts the real
                entries of each shard's levels
    bf_*:       butterfly row-slab layouts stacked on a leading shard
                axis; bf_meta (rb, n_pad, nc_pad, P, tail_n) per shard
    """

    dia_vals: object
    win_sub: object
    win_lane: object
    win_vals: object
    win_base: object
    win_tail_rows: object
    win_tail_cols: object
    win_tail_vals: object
    diag_cols: object
    diag_vals: object
    diag_tail_rows: object
    diag_tail_cols: object
    diag_tail_vals: object
    offd_cols: object
    offd_vals: object
    offd_tail_rows: object
    offd_tail_cols: object
    offd_tail_vals: object
    bf_k1_src: object
    bf_k1_sub: object
    bf_k1_lane: object
    bf_k2_sub: object
    bf_k2_lane: object
    bf_k3_sub: object
    bf_k3_lane: object
    bf_k3_vals: object
    bf_tail_rows: object
    bf_tail_cols: object
    bf_tail_vals: object
    dia_offsets: tuple
    win_width: int
    win_tail_counts: tuple      # per shard: the real entries per level
    bf_meta: tuple | None
    halo: int
    dia_mode: str               # 'halo' | 'gather' | 'none'
    n_devices: int
    n_loc: int
    n_global: int
    n_logical: int

    @property
    def has_dia(self) -> bool:
        return self.dia_mode != "none"

    @property
    def has_ell(self) -> bool:
        return self.diag_cols is not None

    @property
    def has_window(self) -> bool:
        return self.win_vals is not None

    @property
    def has_bfly(self) -> bool:
        return self.bf_k3_vals is not None

    @property
    def dtype(self):
        """"df32" for a double-float partition, else the torch dtype of
        the values."""
        vals = (self.dia_vals if self.has_dia
                else self.bf_k3_vals if self.has_bfly
                else self.win_vals if self.has_window
                else self.diag_vals)
        return "df32" if is_df(vals) else vals.dtype

    def shard(self, rank: int, device) -> "Shard":
        """Rank `rank`'s blocks on `device`."""
        if not 0 <= rank < self.n_devices:
            raise ValueError(f"rank {rank} outside the {self.n_devices} "
                             f"shards")
        dev = torch.device(device)
        s, e = rank * self.n_loc, (rank + 1) * self.n_loc

        def put(a, *idx):
            if is_df(a):
                return DF(put(a.hi, *idx), put(a.lo, *idx))
            return a[idx].contiguous().to(dev)

        dia = put(self.dia_vals, slice(None), slice(s, e)) \
            if self.has_dia else None
        window = bfly = blocks = None
        if self.has_window:
            from mpi_bicgstab_tpu_torch.ops.window_ell import (
                ROWS_PER_TILE, WindowEllMatrix)
            T = self.n_loc // ROWS_PER_TILE
            tiles = (slice(None), slice(rank * T, (rank + 1) * T))
            cap = self.win_tail_rows.shape[1] // self.n_devices
            tail = (slice(None), slice(rank * cap, (rank + 1) * cap))
            window = WindowEllMatrix(
                sub_sel=put(self.win_sub, *tiles),
                lane_idx=put(self.win_lane, *tiles),
                vals=put(self.win_vals, *tiles),
                window_base=put(self.win_base, tiles[1]),
                tail_rows=put(self.win_tail_rows, *tail),
                tail_cols=put(self.win_tail_cols, *tail),
                tail_vals=put(self.win_tail_vals, *tail),
                tail_counts=self.win_tail_counts[rank],
                n_rows=self.n_loc, n_cols=self.n_loc, width=self.win_width,
                x_rows=self.n_loc // 128)
        if self.has_bfly:
            from mpi_bicgstab_tpu_torch.ops.butterfly import ButterflyMatrix
            rb, n_pad, nc_pad, P, tail_n = self.bf_meta
            f = {k: put(getattr(self, f"bf_{k}"), rank) for k in (
                "k1_src", "k1_sub", "k1_lane", "k2_sub", "k2_lane",
                "k3_sub", "k3_lane", "k3_vals", "tail_rows", "tail_cols",
                "tail_vals")}
            bfly = ButterflyMatrix(**f, rb=rb, n_rows=self.n_loc,
                                   n_cols=self.n_global, n_pad=n_pad,
                                   nc_pad=nc_pad, P=P, nnz=0, tail_n=tail_n)
        if self.has_ell:
            def ell(prefix, n_cols):
                t = getattr(self, f"{prefix}_tail_rows").shape[0] \
                    // self.n_devices
                ts = slice(rank * t, (rank + 1) * t)
                return EllMatrix(
                    put(getattr(self, f"{prefix}_cols"), slice(None),
                        slice(s, e)),
                    put(getattr(self, f"{prefix}_vals"), slice(None),
                        slice(s, e)),
                    put(getattr(self, f"{prefix}_tail_rows"), ts),
                    put(getattr(self, f"{prefix}_tail_cols"), ts),
                    put(getattr(self, f"{prefix}_tail_vals"), ts),
                    self.n_loc, n_cols)
            blocks = (ell("diag", self.n_loc), ell("offd", self.n_global))
        return Shard(rank=rank, n_devices=self.n_devices, n_loc=self.n_loc,
                     n_global=self.n_global, dia_mode=self.dia_mode,
                     dia_offsets=self.dia_offsets, halo=self.halo,
                     dia_vals=dia, window=window, bfly=bfly, blocks=blocks)


@dataclasses.dataclass(frozen=True)
class Shard:
    """One rank's blocks on its device (parallel/driver.make_local_spmv
    composes them into the local SpMV)."""

    rank: int
    n_devices: int
    n_loc: int
    n_global: int
    dia_mode: str
    dia_offsets: tuple
    halo: int
    dia_vals: object          # [n_diags, n_loc] | DF | None
    window: object            # WindowEllMatrix (square diag block) | None
    bfly: object              # ButterflyMatrix (n_loc x n_global) | None
    blocks: object            # (diag, offd) EllMatrix pair | None

    @property
    def _vals(self):
        return (self.dia_vals if self.dia_vals is not None
                else self.bfly.k3_vals if self.bfly is not None
                else self.window.vals if self.window is not None
                else self.blocks[0].vals)

    @property
    def dtype(self):
        """"df32" for double-float blocks, else their torch dtype."""
        return "df32" if is_df(self._vals) else self._vals.dtype

    @property
    def device(self) -> torch.device:
        return self._vals.device


def _csr_row_block(csr: CSRMatrix, start: int, end: int,
                   col_lo: int, col_hi: int, localize: bool,
                   n_cols: int) -> CSRMatrix:
    """Rows [start, end), columns inside [col_lo, col_hi) if localize
    else outside (the reference's count/fill split, matrix.c:315-355)."""
    lo, hi = csr.ptr[start], csr.ptr[end]
    col = csr.col[lo:hi]
    val = csr.val[lo:hi]
    rows = np.repeat(np.arange(end - start, dtype=np.int64),
                     np.diff(csr.ptr[start:end + 1]))
    inside = (col >= col_lo) & (col < col_hi)
    keep = inside if localize else ~inside
    col_k = col[keep] - (col_lo if localize else 0)
    counts = np.bincount(rows[keep], minlength=end - start)
    ptr = np.zeros(end - start + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    return CSRMatrix(ptr, col_k, val[keep], (end - start, n_cols))


def _host_vals(a, df_mode: bool):
    """Host values as a CPU tensor, or a DF pair split from float64."""
    a = np.ascontiguousarray(a)
    return df_from_f64(a) if df_mode else torch.from_numpy(a)


def _cat(parts, axis: int = 0):
    if is_df(parts[0]):
        return DF(torch.cat([p.hi for p in parts], axis),
                  torch.cat([p.lo for p in parts], axis))
    return torch.cat(parts, axis)


def _stack(parts):
    if is_df(parts[0]):
        return DF(torch.stack([p.hi for p in parts]),
                  torch.stack([p.lo for p in parts]))
    return torch.stack(parts)


def _pad(a, widths, fill=0):
    """a zero-padded (or `fill`-padded) by ((before, after), ...) per
    axis; pairs leafwise."""
    if is_df(a):
        return DF(_pad(a.hi, widths), _pad(a.lo, widths))
    out = np.pad(a.numpy(), widths, constant_values=fill)
    return torch.from_numpy(out)


def _stack_ell_blocks(blocks, width, vals_dtype, df_mode):
    w = max(1, max(int(b.row_lengths.max()) if b.nnz else 0
                   for b in blocks))
    if width is not None:
        w = min(w, width)
    tail = int(max(max((b.row_lengths - w).clip(min=0).sum()
                       for b in blocks), 0))
    ells = [csr_to_ell(b, width=w, tail_pad=tail, dtype=vals_dtype,
                       device="cpu") for b in blocks]
    vals = (lambda a: _host_vals(a.numpy(), df_mode))  # noqa: E731
    return (torch.cat([e.cols for e in ells], 1),
            vals(torch.cat([e.vals for e in ells], 1)),
            torch.cat([e.tail_rows for e in ells]),
            torch.cat([e.tail_cols for e in ells]),
            vals(torch.cat([e.tail_vals for e in ells])))


def _window_fields(diag_blocks, n_loc, df_mode, vals_dtype, format):
    """The windowed-ELL diag blocks stacked, or None when a block cannot
    take the layout (raises for format='window')."""
    from mpi_bicgstab_tpu_torch.ops.window_ell import csr_to_window_ell
    try:
        wins = [csr_to_window_ell(b, dtype="df32" if df_mode else vals_dtype,
                                  force_x_rows=n_loc // 128, device="cpu")
                for b in diag_blocks]
    except ValueError:
        if format == "window":
            raise   # explicitly requested: surface the reason
        return None  # hub rows: gather-ELL
    W = max(w.width for w in wins)
    cap = max(w.tail_rows.shape[1] for w in wins)
    lv = max(w.tail_rows.shape[0] for w in wins)

    def slabs(a):
        return _pad(a, [(0, W - a.shape[0])] + [(0, 0)] * (a.ndim - 1))

    def tail(a, fill=0):
        # [levels, cap]: padded on both axes to the shards' maxima (level
        # padding is val 0 at row n_loc - 1: inert)
        return _pad(a, ((0, lv - a.shape[0]), (0, cap - a.shape[1])), fill)

    return dict(
        win_sub=_cat([slabs(w.sub_sel) for w in wins], 1),
        win_lane=_cat([slabs(w.lane_idx) for w in wins], 1),
        win_vals=_cat([slabs(w.vals) for w in wins], 1),
        win_base=torch.cat([w.window_base for w in wins]),
        win_tail_rows=_cat([tail(w.tail_rows, max(n_loc - 1, 0))
                            for w in wins], 1),
        win_tail_cols=_cat([tail(w.tail_cols) for w in wins], 1),
        win_tail_vals=_cat([tail(w.tail_vals) for w in wins], 1),
    ), W, tuple(tuple(w.tail_counts) + (0,) * (lv - len(w.tail_counts))
                for w in wins)


def _butterfly_fields(slabs, df_mode, vals_dtype, format):
    """The butterfly row slabs routed on one geometry and stacked, or
    None when a slab cannot take the layout (raises for
    format='butterfly')."""
    from mpi_bicgstab_tpu_torch.ops.butterfly import butterfly_tables
    bdt = "df32" if df_mode else vals_dtype
    try:
        bfs = [butterfly_tables(b, dtype=bdt, seed=7 + d)
               for d, b in enumerate(slabs)]
        rbs = {b["rb"] for b in bfs}
        if len(rbs) > 1 or len({b["P"] for b in bfs}) > 1:
            # the shards share one routing geometry: rebuild with the
            # harmonised (rb, P)
            rb_f = min(rbs)
            bfs = [butterfly_tables(b, dtype=bdt, seed=7 + d,
                                    rb_force=rb_f)
                   for d, b in enumerate(slabs)]
            if len({b["P"] for b in bfs}) > 1:
                P_f = max(b["P"] for b in bfs)
                bfs = [butterfly_tables(b, dtype=bdt, seed=7 + d,
                                        rb_force=rb_f, P_force=P_f)
                       for d, b in enumerate(slabs)]
    except ValueError:
        if format == "butterfly":
            raise   # explicitly requested: surface the reason
        return None
    W = max(b["k3_lane"].shape[0] * b["k3_lane"].shape[1] for b in bfs)
    lv = max(b["tail_rows"].shape[0] for b in bfs)
    cap = max(b["tail_rows"].shape[1] for b in bfs)

    def k3(a):      # [W//8, 8, NR, 128]: pad the leading chunk axis
        a = _host_vals(a, df_mode) if a.dtype.kind == "f" \
            else torch.from_numpy(np.ascontiguousarray(a))
        return _pad(a, [(0, W // 8 - a.shape[0])] + [(0, 0)] * 3)

    def tail(a):
        a = _host_vals(a, df_mode) if a.dtype.kind == "f" \
            else torch.from_numpy(np.ascontiguousarray(a))
        return _pad(a, ((0, lv - a.shape[0]), (0, cap - a.shape[1])))

    def plain(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    fields = dict(
        bf_k1_src=_stack([plain(b["k1_src"]) for b in bfs]),
        bf_k1_sub=_stack([plain(b["k1_sub"]) for b in bfs]),
        bf_k1_lane=_stack([plain(b["k1_lane"]) for b in bfs]),
        bf_k2_sub=_stack([plain(b["k2_sub"]) for b in bfs]),
        bf_k2_lane=_stack([plain(b["k2_lane"]) for b in bfs]),
        bf_k3_sub=_stack([k3(b["k3_sub"]) for b in bfs]),
        bf_k3_lane=_stack([k3(b["k3_lane"]) for b in bfs]),
        bf_k3_vals=_stack([k3(b["k3_vals"]) for b in bfs]),
        bf_tail_rows=_stack([tail(b["tail_rows"]) for b in bfs]),
        bf_tail_cols=_stack([tail(b["tail_cols"]) for b in bfs]),
        bf_tail_vals=_stack([tail(b["tail_vals"]) for b in bfs]),
    )
    b0 = bfs[0]
    return fields, (b0["rb"], b0["n_pad"], b0["nc_pad"], b0["P"],
                    max(b["tail_n"] for b in bfs))


def _cached(csr, n_devices, dtype, width, format, max_diags, dia_min_fill,
            cache_dir, align):
    """partition_csr through the layout cache (utils/opcache.py): the
    whole PartitionedMatrix keyed by the matrix content and every
    option."""
    from mpi_bicgstab_tpu_torch.utils import opcache
    dtype_tag = "df32" if is_df32(dtype) else str(
        host_dtype(dtype, csr.val.dtype))
    key = opcache.operator_key(
        csr, kind="partition", n_devices=n_devices, dtype=dtype_tag,
        width=width, format=format, max_diags=max_diags,
        dia_min_fill=dia_min_fill, align=align,
        router=native_route.router())
    part = opcache.load_operator(cache_dir, key)
    if part is None:
        part = partition_csr(csr, n_devices, dtype=dtype, width=width,
                             format=format, max_diags=max_diags,
                             dia_min_fill=dia_min_fill, cache_dir="off",
                             align=align)
        opcache.save_operator(cache_dir, key, part)
    return part


def partition_csr(csr: CSRMatrix, n_devices: int, dtype=None,
                  width: int | None = None, format: str = "auto",
                  max_diags: int = 64, dia_min_fill: float = 0.02,
                  cache_dir: str | None = None,
                  align: int = 8) -> PartitionedMatrix:
    """Partition a square CSR into per-shard DIA, windowed-ELL, butterfly
    and ELL blocks.

    format: 'auto' (the diagonal analysis routes between DIA, hybrid and
    the unstructured layouts), 'dia' (DIA plus an ELL remainder), 'ell'
    (pure gather-ELL, the layout of the reference), 'window' or
    'butterfly' (raise when the matrix cannot take them). dtype: float32,
    float64 (the CSR's by default) or "df32".

    cache_dir: the layout cache (utils/opcache.py; default
    MBT_LAYOUT_CACHE, '0'/'off' disables).

    align: per-shard row alignment (identity padding makes n_loc a
    multiple of it; at least 8)."""
    if csr.shape[0] != csr.shape[1]:
        raise ValueError("matrix must be square")
    if cache_dir is None:
        cache_dir = os.environ.get("MBT_LAYOUT_CACHE") or "off"
    if cache_dir.lower() not in ("0", "off"):
        return _cached(csr, n_devices, dtype, width, format, max_diags,
                       dia_min_fill, cache_dir, align)
    df_mode = is_df32(dtype)
    vals_dtype = host_dtype(dtype, csr.val.dtype)
    n_logical = csr.nrows
    csr = pad_csr_identity(csr, max(8, align) * n_devices)
    n_global = csr.nrows
    n_loc = n_global // n_devices

    fields = dict.fromkeys(_ELL_FIELDS + _WIN_FIELDS + _BFLY_FIELDS)
    fields["dia_vals"] = None
    dia_offsets, dia_mode, halo = (), "none", 0
    remainder = csr
    win_width, win_counts, bf_meta = 0, (), None

    if format not in ("ell", "window", "butterfly"):
        # a FORCED unstructured format must not let the DIA pass consume
        # the matrix first (a banded matrix would then silently measure
        # DIA instead of the requested layout)
        offsets, coverage = analyze_diagonals(csr, max_diags=max_diags,
                                              min_fill=dia_min_fill)
        if format == "dia" or (offsets and coverage >= 0.5):
            dia, remainder = csr_to_dia(csr, offsets,
                                        dtype=dtype if df_mode
                                        else vals_dtype, device="cpu")
            fields["dia_vals"] = dia.vals
            dia_offsets = offsets
            m = max((max(offsets), -min(offsets), 0)) if offsets else 0
            if m <= n_loc:
                dia_mode = "halo"
                halo = min(-(-m // 128) * 128, n_loc) if m else 0
            else:
                # band wider than a shard: no halo; gather the iterate
                dia_mode = "gather"

    if remainder is not None and (remainder is csr or remainder.nnz > 0):
        remainder = CSRMatrix(remainder.ptr, remainder.col,
                              remainder.val.astype(vals_dtype),
                              remainder.shape)
        diag_blocks, offd_blocks = [], []
        for d in range(n_devices):
            s, e = d * n_loc, (d + 1) * n_loc
            diag_blocks.append(_csr_row_block(remainder, s, e, s, e, True,
                                              n_loc))
            offd_blocks.append(_csr_row_block(remainder, s, e, s, e, False,
                                              n_global))
        # windowed-ELL diag blocks: each shard's square diag block takes
        # the layout when its columns cluster; the off-diagonal coupling
        # stays on the gathered ELL path
        use_window = (dia_mode == "none" and format in ("auto", "window")
                      and n_loc % 1024 == 0)
        if format == "window" and not use_window:
            # an explicit request must not silently measure the ELL path
            raise ValueError(
                "format='window' requires pure-unstructured blocks "
                f"(dia_mode={dia_mode!r}) and n_loc % 1024 == 0 "
                f"(n_loc={n_loc}); use format='auto' for fallback")
        if use_window and format == "auto":
            from mpi_bicgstab_tpu_torch.ops.window_ell import \
                window_ell_stats
            use_window = all(window_ell_stats(b)["window_frac"] >= 0.95
                             for b in diag_blocks)
        win = _window_fields(diag_blocks, n_loc, df_mode, vals_dtype,
                             format) if use_window else None
        if win is not None:
            win_fields, win_width, win_counts = win
            fields.update(win_fields)
            # the diag entries live in the window layout now; the diag
            # ELL slot keeps a zero-width placeholder
            diag_blocks = [CSRMatrix(np.zeros(n_loc + 1, np.int64),
                                     np.zeros(0, np.int64),
                                     np.zeros(0, remainder.val.dtype),
                                     (n_loc, n_loc))
                           for _ in range(n_devices)]
        # butterfly row slabs (each shard's rows x ALL columns over the
        # gathered iterate: the reference's own pattern, matrix.c:432, no
        # halo structure exists); replaces the diag/offd split entirely
        bf = None
        if win is None and dia_mode == "none" \
                and format in ("auto", "butterfly"):
            slabs = []
            for d in range(n_devices):
                s0, e0 = d * n_loc, (d + 1) * n_loc
                lo_, hi_ = remainder.ptr[s0], remainder.ptr[e0]
                slabs.append(CSRMatrix(
                    (remainder.ptr[s0:e0 + 1] - lo_).astype(np.int64),
                    remainder.col[lo_:hi_], remainder.val[lo_:hi_],
                    (n_loc, n_global)))
            bf = _butterfly_fields(slabs, df_mode, vals_dtype, format)
        if bf is not None:
            bf_fields, bf_meta = bf
            fields.update(bf_fields)
        else:
            ell = _stack_ell_blocks(diag_blocks, width, vals_dtype, df_mode) \
                + _stack_ell_blocks(offd_blocks, width, vals_dtype, df_mode)
            fields.update(zip(_ELL_FIELDS, ell))

    return PartitionedMatrix(
        **fields, dia_offsets=dia_offsets, win_width=win_width,
        win_tail_counts=win_counts, bf_meta=bf_meta, halo=halo,
        dia_mode=dia_mode, n_devices=n_devices, n_loc=n_loc,
        n_global=n_global, n_logical=n_logical)
