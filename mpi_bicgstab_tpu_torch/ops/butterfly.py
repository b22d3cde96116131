"""Butterfly-routed layout for matrices with no column locality at any
permutation, such as uniform random sparse operators (counterpart of
mpi_bicgstab_tpu/ops/butterfly.py; the same CSR and seed give the same
arrays, so a layout built by either package runs in the other).

The JAX package's SpMV over it factors the arbitrary gather of x into
three stages whose gathers stay inside 1024-element windows, around two
element transposes:

  x --K1--> u1 [P,1024] --T1--> mid [P,1024] --K2--> z1 --T2--> z --K3--> y

with P = 1024 G windows, G odd (coprime to 1024):

  K1  window a of u1 copies elements of one source window k1_src[a] of x
      (the copies an element needs across destination windows).
  T1  the transpose [P, 1024] -> [1024, P], read flat as [P, 1024]:
      element (a, b) lands in middle window m = b G + a_hi at slot a_lo
      (a = 1024 a_hi + a_lo).
  K2  a permutation inside each window: slot a_lo -> q.
  T2  the same transpose: element (m, q) lands in destination window
      d = q G + m_hi at slot m_lo (m = 1024 m_hi + m_lo).
  K3  the SpMV: output rows in tiles of 128, each tile reading its F =
      128 / rb stacked destination windows (rb output rows a window); a
      slab-major ELL of values multiplies the gathered entries.

Every gather index is a pair (sublane, lane) of int8 tables, sublane and
lane of a [8, 128] window: slot (i, j) reads window element
sub[i, lam] * 128 + lam with lam = lane[i, j] (the sublane table is
indexed by the source lane: the form the TPU's chained gathers need).

The route does not depend on x, so the port runs it once per layout:
the column table k3_col (ops/butterfly_spmv.column_table, derived when
the layout is constructed, never part of the JAX arrays) names the
column of x each K3 slot reads, and an SpMV on the card is one K3 launch
over x and the tail (ops/butterfly_spmv.py).

Routing (host, once per matrix): an element bound for destination (d,
m_lo) has m_hi = d mod G and q = d div G fixed; the assigner picks its u1
window and its middle window under the slot and lane uniqueness rules
(_assign_routes: the C++ assigner csrc/butterfly_route.cpp, or the JAX
package's global NumPy rounds when MBT_NATIVE_ROUTE is 0 / off or the
assigner cannot allocate; ops/native_route.py), then the K3 entries are
coloured into slabs (by the same two routes); what does not fit (a few
per mille) spills to a tail, leveled by duplicate rank as in ops/window_ell.py (within a level
a row appears at most once; padding entries are row 0, column 0, value
0).

simulate_numpy(bf, x) runs the routed pipeline on host copies of the
tables with the chained-gather semantics, never reading k3_col: an
oracle independent of the column table.

The reference's unstructured `mult` (matrix.c:498-516).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpi_bicgstab_tpu_torch.ops import native_route
from mpi_bicgstab_tpu_torch.ops.dia import (LayoutRefused, host_dtype,
                                            is_df32)
from mpi_bicgstab_tpu_torch.ops.precision import df_from_f64, is_df
from mpi_bicgstab_tpu_torch.utils.config import canon_dtype
from mpi_bicgstab_tpu_torch.utils.device import resolve_device

WIN = 1024          # window size: 8 sublanes x 128 lanes
LANES = 128
SUB = 8
_MAX_LOAD = 0.55    # distinct columns per destination window, as a share


@dataclasses.dataclass(frozen=True)
class ButterflyMatrix:
    """The routed SpMV's tables (the JAX package's fields), as tensors on
    one device.

    k1_src:  int32 [P]: the source window (of 1024 columns) of u1 window a
    k1_sub, k1_lane: int8 [P, 8, 128]: K1's x-window sublane and lane
    k2_sub, k2_lane: int8 [P, 8, 128]: K2's input-slot sublane and lane
    k3_sub:  int8 [W//8, 8, NR, 128] (NR = n_pad // 128): the STACKED
             sublane (row % 128) // rb * 8 + slot // 128, indexed by source
             lane within the row tile; the [W, n_pad] form reshaped
    k3_lane: int8 [W//8, 8, NR, 128]: the slot's lane
    k3_vals: [W//8, 8, NR, 128] values (a DF pair for df32)
    k3_col:  int32 [W//8, 8, NR, 128]: the column of x the slot reads
             through K1, T1, K2, T2 (-1: K1's zero past the last column);
             derived: every construction (dataclasses.replace too) routes
             it from the tables above, on their device (on the card one K1,
             one K2 and one decode launch)
    tail_rows, tail_cols: int32 [L, cap]; tail_vals [L, cap]: the spill
    rb: output rows per destination window (64, 32 or 16)
    n_pad: rows padded to a multiple of 2048; nc_pad: columns to 1024
    P: u1 windows (a multiple of 1024, P // 1024 odd)
    tail_n: the tail's real entries
    """

    k1_src: torch.Tensor
    k1_sub: torch.Tensor
    k1_lane: torch.Tensor
    k2_sub: torch.Tensor
    k2_lane: torch.Tensor
    k3_sub: torch.Tensor
    k3_lane: torch.Tensor
    k3_vals: torch.Tensor
    tail_rows: torch.Tensor
    tail_cols: torch.Tensor
    tail_vals: torch.Tensor
    rb: int
    n_rows: int
    n_cols: int
    n_pad: int
    nc_pad: int
    P: int
    nnz: int
    tail_n: int
    k3_col: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        from mpi_bicgstab_tpu_torch.ops.butterfly_spmv import column_table
        object.__setattr__(self, "k3_col", column_table(self))

    @property
    def G(self) -> int:
        return self.P // WIN

    @property
    def stack(self) -> int:
        """Windows stacked per 128-lane output row tile (128 // rb)."""
        return LANES // self.rb

    @property
    def width(self) -> int:
        """Slabs W of the K3 tables (a multiple of 8)."""
        return self.k3_lane.shape[0] * self.k3_lane.shape[1]

    @property
    def tail_count(self) -> int:
        return self.tail_n

    @property
    def dtype(self):
        return self.k3_vals.dtype

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def device(self):
        return self.k3_lane.device


def _pad_up(x: int, m: int) -> int:
    return -(-x // m) * m


def butterfly_stats(csr, rb: int = 64) -> dict:
    """Feasibility probe: distinct columns per rb-row block (each must be
    <= 1024 for a destination window to hold them) and the widest row."""
    n = csr.nrows
    rows = np.repeat(np.arange(n, dtype=np.int64), csr.row_lengths)
    key = (rows // rb) * (np.int64(csr.shape[1]) + 1) + csr.col
    uniq = np.unique(key)
    counts = np.bincount((uniq // (csr.shape[1] + 1)).astype(np.int64),
                         minlength=_pad_up(n, rb) // rb)
    return {"max_distinct": int(counts.max()) if counts.size else 0,
            "mean_distinct": float(counts.mean()) if counts.size else 0.0,
            "max_row_width": int(csr.row_lengths.max()) if n else 0}


def _window_table(k_s, G: int):
    """Each (source window s, level j < k_s[s]) pair's u1 window: groups
    by hashed round-robin, resolved to <= 1024 windows a group by linear
    probing; window = group * 1024 + rank within the group. Returns
    win_a [Ts, max_k] (-1 where unused)."""
    Ts, max_k = k_s.size, int(k_s.max())
    pair_s = np.repeat(np.arange(Ts, dtype=np.int64), k_s)
    pair_j = np.concatenate([np.arange(k, dtype=np.int64) for k in k_s])
    g = (pair_s + pair_j * (7919 % G or 1)) % G
    rank = np.zeros(pair_s.size, np.int64)
    for _ in range(G + 2):
        order = np.argsort(g, kind="stable")
        gs = g[order]
        first = np.r_[True, gs[1:] != gs[:-1]]
        starts = np.nonzero(first)[0]
        rk = np.arange(gs.size) - np.repeat(
            starts, np.diff(np.r_[starts, gs.size]))
        over = rk >= WIN
        rank[order] = rk
        if not over.any():
            break
        g[order[over]] = (gs[over] + 1) % G
    else:
        raise LayoutRefused("u1 window placement overflow")
    win_a = np.full((Ts, max_k), -1, np.int64)
    win_a[pair_s, pair_j] = g * WIN + rank
    return win_a


def _assign_routes(u_blk, u_col, nc_pad: int, seed: int, rounds: int,
                   n_blocks: int, P_force: int | None = None):
    """Choose (u1 window a, middle window m) for every distinct element
    (destination block u_blk, column u_col) under four uniqueness
    families: one element per destination slot (d, m_lo) and per u1 slot
    (a, b), strictly; and K1's and K2's gather-row lane injectivity,
    (a, b // 128, source lane) and (m, q // 128, a mod 128), which a
    rider on the same value may share. The native assigner routes them
    when it answers; else `rounds` global NumPy rounds (_route_rounds).
    Returns (P, a_sel, m_sel, ok)."""
    src = u_col // WIN
    Ts = nc_pad // WIN
    out_deg = np.bincount(src, minlength=Ts)
    k_s = np.maximum(1, np.ceil(out_deg / (WIN * _MAX_LOAD)).astype(np.int64))
    # every padded output block needs its destination window: K3 streams
    # z for every padded output row
    P = _pad_up(max(int(k_s.sum()), n_blocks, WIN), WIN)
    if (P // WIN) % 2 == 0:
        P += WIN
    if P_force is not None:
        # the shards of a row partition share P (it fixes the routing
        # geometry G = P / 1024); the partition passes the largest
        if P_force < P:
            raise LayoutRefused(f"P_force {P_force} < natural P {P}")
        P = P_force
    G = P // WIN
    win_a = _window_table(k_s, G)
    # d < n_blocks <= P = 1024 G, so q = d // G < 1024: a window slot
    routes = native_route.assign_native(
        u_blk, u_col, u_blk % G, u_blk // G, u_col % LANES, win_a, k_s,
        win_a.shape[1], Ts, G, P, n_blocks, seed)
    if routes is None:
        routes = _route_rounds(u_blk, u_col, win_a, k_s, G, P, n_blocks,
                               seed, rounds)
    a_sel, m_sel = routes
    return P, a_sel, m_sel, a_sel >= 0


def _winners(idx, claims, scratch):
    """The proposals of idx that win each claim (key, value) in turn: the
    last writer per key wins and a rider with the winner's value passes.
    Every scratch position read is written in the same step, so scratch
    needs no reset between rounds."""
    for key, v in claims:
        k_i, v_i = key[idx], v[idx]
        scratch[k_i] = v_i
        idx = idx[scratch[k_i] == v_i]
    return idx


def _route_rounds(d, u_col, win_a, n_opts, G: int, P: int, Td: int,
                  seed: int, rounds: int):
    """The NumPy router (the JAX package's, draw for draw): in each round
    every element still to place draws a random option (its u1 window
    among its source's n_opts, then its middle window in the stride-G
    class of that window's group); proposals that the dense claim maps
    allow resolve by scatter, the last writer per key winning and riders
    on an equal value passing, and the winners claim their keys. Round 0
    skips the checks (every map is empty). Returns (a_sel, m_sel), -1
    where an element is still unplaced after `rounds` rounds."""
    rng = np.random.default_rng(seed)
    E = d.size
    src = u_col // WIN
    m_hi = d % G
    q = d // G
    src_lane = u_col % LANES
    a_sel = np.full(E, -1, np.int64)
    m_sel = np.full(E, -1, np.int64)
    PB64 = np.int64(P) * WIN
    taken_d = np.zeros(Td * WIN, bool)           # d * 1024 + m_lo
    taken_a = np.zeros(PB64, bool)               # a * 1024 + b
    # value maps hold v + 1, 0 = empty
    val_l1 = np.zeros(PB64, np.int32)            # a*1024 + brow*128 + lane
    val_l2 = np.zeros(PB64, np.int32)            # m*1024 + qrow*128 + lane
    scratch = np.zeros(max(PB64, Td * WIN), np.int64)   # winners
    todo = np.arange(E)
    for rnd in range(rounds):
        if todo.size == 0:
            break
        s_t = src[todo]
        j = rng.integers(0, 1 << 30, todo.size) % n_opts[s_t]
        a_t = win_a[s_t, j]
        a_hi = a_t // WIN
        mh = m_hi[todo]
        base = 1024 * mh + ((a_hi - 1024 * mh) % G)
        n_t = (1024 * mh + WIN - 1 - base) // G + 1
        t = rng.integers(0, 1 << 30, todo.size) % n_t
        m_t = base + G * t
        b_t = (m_t - a_hi) // G
        kd = d[todo] * np.int64(WIN) + (m_t % WIN)
        ka = a_t * np.int64(WIN) + b_t
        kl1 = a_t * np.int64(WIN) + (b_t // LANES) * LANES + src_lane[todo]
        vl1 = u_col[todo].astype(np.int32) + 1
        kl2 = m_t * np.int64(WIN) + (q[todo] // LANES) * LANES \
            + (a_t % LANES)
        vl2 = (a_t % WIN).astype(np.int32) + 1
        if rnd == 0:
            idx = np.arange(todo.size)
        else:
            idx = np.nonzero(~taken_d[kd] & ~taken_a[ka]
                             & ((val_l1[kl1] == 0) | (val_l1[kl1] == vl1))
                             & ((val_l2[kl2] == 0)
                                | (val_l2[kl2] == vl2)))[0]
        idx = _winners(idx, ((kd, todo), (ka, todo), (kl1, vl1),
                             (kl2, vl2)), scratch)
        e_win = todo[idx]
        a_sel[e_win] = a_t[idx]
        m_sel[e_win] = m_t[idx]
        taken_d[kd[idx]] = True
        taken_a[ka[idx]] = True
        val_l1[kl1[idx]] = vl1[idx]
        val_l2[kl2[idx]] = vl2[idx]
        keep = np.ones(todo.size, bool)
        keep[idx] = False
        todo = todo[keep]
    return a_sel, m_sel


def _colour_rounds(r_all, grp, lane3, sub3, n_pad: int, W3: int,
                   seed: int):
    """The NumPy slab colouring (the JAX package's, draw for draw):
    4 W3 + 12 rounds of random slabs for the entries still to place, a
    row at most once per slab and one stacked sublane per (row tile,
    slab, lane), winners as in _route_rounds (_winners). Returns w_sel,
    -1 where an entry spills."""
    NR = n_pad // LANES
    NE = r_all.size
    w_sel = np.full(NE, -1, np.int64)
    taken_row = np.zeros(n_pad * W3, bool)
    val_gl = np.zeros(NR * W3 * LANES, np.int16)        # v + 1, 0 = empty
    scratch = np.zeros(max(n_pad * W3, NR * W3 * LANES), np.int64)
    rng = np.random.default_rng(seed)
    todo = np.arange(NE)
    for _ in range(4 * W3 + 12):
        if todo.size == 0:
            break
        w_t = rng.integers(0, 1 << 30, todo.size) % W3
        krow = r_all[todo] * np.int64(W3) + w_t
        kgl = (grp[todo] * np.int64(W3) + w_t) * LANES + lane3[todo]
        vgl = sub3[todo].astype(np.int16) + 1
        idx = np.nonzero(~taken_row[krow]
                         & ((val_gl[kgl] == 0) | (val_gl[kgl] == vgl)))[0]
        idx = _winners(idx, ((krow, todo), (kgl, vgl)), scratch)
        w_sel[todo[idx]] = w_t[idx]
        taken_row[krow[idx]] = True
        val_gl[kgl[idx]] = vgl[idx]
        keep = np.ones(todo.size, bool)
        keep[idx] = False
        todo = todo[keep]
    return w_sel


def _tail_levels(t_rows, t_cols, t_vals, vals_dtype):
    """The spilled entries as [L, cap] levels by duplicate rank within
    their row (padding: row 0, column 0, value 0)."""
    if not t_rows.size:
        return (np.zeros((1, 1), np.int32), np.zeros((1, 1), np.int32),
                np.zeros((1, 1), vals_dtype))
    o2 = np.argsort(t_rows, kind="stable")
    tr = t_rows[o2]
    st2 = np.nonzero(np.r_[True, tr[1:] != tr[:-1]])[0]
    lvl = np.arange(tr.size) - np.repeat(st2, np.diff(np.r_[st2, tr.size]))
    L = int(lvl.max()) + 1
    cap = max(int(np.bincount(lvl, minlength=L).max()), 1)
    rows = np.zeros((L, cap), np.int32)
    cols = np.zeros((L, cap), np.int32)
    vals = np.zeros((L, cap), vals_dtype)
    o3 = np.lexsort((tr, lvl))
    lv3, tr3 = lvl[o3], tr[o3]
    st3 = np.nonzero(np.r_[True, lv3[1:] != lv3[:-1]])[0]
    p3 = np.arange(lv3.size) - np.repeat(st3, np.diff(np.r_[st3, lv3.size]))
    rows[lv3, p3] = tr3.astype(np.int32)
    cols[lv3, p3] = t_cols[o2][o3].astype(np.int32)
    vals[lv3, p3] = t_vals[o2][o3]
    return rows, cols, vals


def build_butterfly(csr, dtype=None, seed: int = 0, rounds: int = 80,
                    max_width: int = 24, max_tail_frac: float = 0.005,
                    P_force: int | None = None, rb_force: int | None = None,
                    device="cuda") -> ButterflyMatrix:
    """Route csr (square or rectangular) and build the layout on
    `device`; LayoutRefused (a ValueError) when it is not routable (a row
    wider than max_width, a block whose distinct columns overflow a
    window, or a spill above max_tail_frac of the nonzeros). The
    destination block's row count rb adapts (64 -> 32 -> 16) until every
    block's distinct columns fit a window at <= 0.55 load. dtype:
    float32, float64 (the CSR's by default) or "df32" (DF pairs split
    from float64). rb_force and P_force fix rb and the u1 window count P,
    so that the shards of a row partition (parallel/partition.py) share
    one routing geometry. rounds: the NumPy router's rounds, where the
    native assigner does not answer (ops/native_route.py)."""
    dev = resolve_device(device)
    t = butterfly_tables(csr, dtype=dtype, seed=seed, rounds=rounds,
                         max_width=max_width,
                         max_tail_frac=max_tail_frac, P_force=P_force,
                         rb_force=rb_force)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    put_v = (lambda a: df_from_f64(a, dev)) if is_df32(dtype) else put
    vals = ("k3_vals", "tail_vals")
    return ButterflyMatrix(**{k: (put_v(v) if k in vals else put(v))
                              if isinstance(v, np.ndarray) else v
                              for k, v in t.items()})


def butterfly_tables(csr, dtype=None, seed: int = 0, rounds: int = 80,
                     max_width: int = 24, max_tail_frac: float = 0.005,
                     P_force: int | None = None,
                     rb_force: int | None = None) -> dict:
    """build_butterfly's routed tables as host NumPy arrays (the values in
    float64 for "df32") and its sizes, by ButterflyMatrix field name."""
    vals_dtype = host_dtype(dtype, csr.val.dtype)
    n, n_cols = csr.shape
    n_pad = _pad_up(n, 2 * WIN)        # rows: whole pairs of row tiles
    nc_pad = _pad_up(n_cols, WIN)      # columns: whole source windows
    lengths = csr.row_lengths
    W = int(lengths.max()) if n else 0
    if W == 0 or W > max_width:
        raise LayoutRefused(f"row width {W} outside (0, {max_width}]")

    rows = np.repeat(np.arange(n, dtype=np.int64), lengths)
    cols = csr.col.astype(np.int64)
    vals = csr.val.astype(vals_dtype)
    for rb in ((rb_force,) if rb_force else (64, 32, 16)):
        key = (rows // rb) * np.int64(nc_pad + 1) + cols
        uniq_key, entry_elem = np.unique(key, return_inverse=True)
        u_blk = (uniq_key // (nc_pad + 1)).astype(np.int64)
        u_col = (uniq_key % (nc_pad + 1)).astype(np.int64)
        per_blk = np.bincount(u_blk, minlength=n_pad // rb)
        if per_blk.max() <= int(WIN * _MAX_LOAD):
            break
    else:
        if per_blk.max() > WIN:
            raise LayoutRefused(
                f"a {rb}-row block needs {int(per_blk.max())} distinct "
                f"columns (> {WIN}): not butterfly-routable")

    P, a_sel, m_sel, ok = _assign_routes(u_blk, u_col, nc_pad, seed,
                                         rounds, n_pad // rb,
                                         P_force=P_force)
    G = P // WIN
    if (~ok).sum() > max_tail_frac * max(u_blk.size, 1):
        raise LayoutRefused(f"routing spill {int((~ok).sum())}/{u_blk.size} "
                         f"exceeds {max_tail_frac:.1%}")

    # K1: the lane table at the OUTPUT slot, the sublane table at the
    # SOURCE lane (slot (i, j) reads sub[i, lane[i, j]]); the routing's
    # K1 lane family keeps the sublane entry single-valued
    a_ok, m_ok = a_sel[ok], m_sel[ok]
    a_hi = a_ok // WIN
    b_ok = (m_ok - a_hi) // G
    src_ln = u_col[ok] % LANES
    k1_src = np.zeros(P, np.int32)
    k1_src[a_ok] = (u_col[ok] // WIN).astype(np.int32)
    k1_sub = np.zeros((P, SUB, LANES), np.int8)
    k1_lane = np.zeros((P, SUB, LANES), np.int8)
    k1_lane[a_ok, b_ok // LANES, b_ok % LANES] = src_ln.astype(np.int8)
    k1_sub[a_ok, b_ok // LANES, src_ln] = \
        ((u_col[ok] % WIN) // LANES).astype(np.int8)

    # K2: the same form (the routing's K2 lane family)
    q_ok = u_blk[ok] // G
    a_lo = a_ok % WIN
    k2_sub = np.zeros((P, SUB, LANES), np.int8)
    k2_lane = np.zeros((P, SUB, LANES), np.int8)
    k2_lane[m_ok, q_ok // LANES, q_ok % LANES] = \
        (a_lo % LANES).astype(np.int8)
    k2_sub[m_ok, q_ok // LANES, a_lo % LANES] = \
        (a_lo // LANES).astype(np.int8)

    # K3: entry (row, element) reads z at stacked sublane
    # (row % 128) // rb * 8 + slot // 128 and lane slot % 128 of its row
    # tile; colour the entries into slabs so that a row appears once per
    # slab and each (tile, slab, lane) has one stacked sublane (riders on
    # the same value pass)
    elem_slot = np.zeros(u_blk.size, np.int64)
    elem_slot[ok] = m_ok % WIN
    entry_ok = ok[entry_elem]
    r_all = rows[entry_ok]
    v_all = vals[entry_ok]
    slot_all = elem_slot[entry_elem[entry_ok]]
    lane3 = slot_all % LANES
    sub3 = (r_all % LANES) // rb * SUB + slot_all // LANES
    grp = r_all // LANES
    # slabs with slack: at W3 = W a tile's lanes are all but full and the
    # colouring cannot close; widen until the spill is tiny
    for W3 in (int(W * 1.4) + 1, int(W * 1.8) + 1, 2 * W + 2):
        w_sel = native_route.color_native(r_all, grp, lane3, sub3, n_pad,
                                          n_pad // LANES, W3, seed + 1)
        if w_sel is None:
            w_sel = _colour_rounds(r_all, grp, lane3, sub3, n_pad, W3,
                                   seed + 1)
        if (w_sel < 0).sum() <= 0.3 * max_tail_frac * max(csr.nnz, 1):
            break
    placed = w_sel >= 0
    W = _pad_up(W3, SUB)               # K3 walks the slabs in chunks of 8
    k3_sub = np.zeros((W, n_pad), np.int8)
    k3_lane = np.zeros((W, n_pad), np.int8)
    k3_vals = np.zeros((W, n_pad), vals_dtype)
    pw, pr = w_sel[placed], r_all[placed]
    k3_lane[pw, pr] = lane3[placed].astype(np.int8)
    k3_vals[pw, pr] = v_all[placed]
    k3_sub.reshape(W, n_pad // LANES, LANES)[
        pw, grp[placed], lane3[placed]] = sub3[placed].astype(np.int8)

    # the tail: the routing's spill and the colouring's
    t_rows = np.concatenate([rows[~entry_ok], r_all[~placed]])
    t_cols = np.concatenate([cols[~entry_ok], cols[entry_ok][~placed]])
    t_vals = np.concatenate([vals[~entry_ok], v_all[~placed]])
    tail_n = int(t_rows.size)
    if tail_n > max_tail_frac * max(csr.nnz, 1):
        raise LayoutRefused(
            f"total spill {tail_n}/{csr.nnz} exceeds {max_tail_frac:.1%}")
    tail_rows, tail_cols, tail_vals = _tail_levels(t_rows, t_cols, t_vals,
                                                   vals_dtype)

    def r4(a):      # the kernel-ready [W//8, 8, NR, 128] view of [W, n_pad]
        return a.reshape(W // SUB, SUB, n_pad // LANES, LANES)

    return dict(
        k1_src=k1_src, k1_sub=k1_sub, k1_lane=k1_lane, k2_sub=k2_sub,
        k2_lane=k2_lane, k3_sub=r4(k3_sub), k3_lane=r4(k3_lane),
        k3_vals=r4(k3_vals), tail_rows=tail_rows, tail_cols=tail_cols,
        tail_vals=tail_vals, rb=rb, n_rows=n, n_cols=n_cols, n_pad=n_pad,
        nc_pad=nc_pad, P=P, nnz=csr.nnz, tail_n=tail_n)


def butterfly_with_values(A: ButterflyMatrix, dtype,
                          device="cuda") -> ButterflyMatrix:
    """The layout A (float64 values) with its values cast to dtype
    (float32, float64, or "df32" pairs split from float64) on `device`:
    what build_butterfly(csr, dtype=dtype) builds from A's CSR (the
    routing does not depend on the value type), without a second
    routing. The column table is routed anew on `device`."""
    dev = resolve_device(device)
    if is_df(A.k3_vals) or A.k3_vals.dtype != torch.float64:
        raise TypeError("butterfly_with_values takes float64 values")

    def cast(v):
        if is_df32(dtype):
            return df_from_f64(v.cpu().numpy(), dev)
        return v.to(device=dev, dtype=canon_dtype(dtype))

    move = {k: getattr(A, k).to(dev) for k in
            ("k1_src", "k1_sub", "k1_lane", "k2_sub", "k2_lane", "k3_sub",
             "k3_lane", "tail_rows", "tail_cols")}
    return dataclasses.replace(A, k3_vals=cast(A.k3_vals),
                               tail_vals=cast(A.tail_vals), **move)


def _host(a) -> np.ndarray:
    """A table as host NumPy; a DF pair as hi + lo in float32, as the JAX
    package's simulate_numpy sums its host pair."""
    if is_df(a):
        return a.hi.detach().cpu().numpy() + a.lo.detach().cpu().numpy()
    return a.detach().cpu().numpy()


def simulate_numpy(bf: ButterflyMatrix, x: np.ndarray) -> np.ndarray:
    """y = A x by the routed pipeline in NumPy on host copies of bf's
    tables, with the device kernels' chained-gather semantics (t1 =
    take_along_axis(win, sub, axis=sublane), out = take_along_axis(t1,
    lane, axis=lane)): K1, T1, K2, T2, the stacked K3 gather, the slab
    sum and np.add.at of the tail (the JAX package's simulate_numpy, step
    for step). It does not read k3_col."""
    n_pad, P = bf.n_pad, bf.P
    xp = np.zeros(bf.nc_pad, x.dtype)
    xp[: x.size] = x
    xw = xp.reshape(bf.nc_pad // WIN, SUB, LANES)
    win = xw[_host(bf.k1_src)]                              # [P, 8, 128]
    t1 = np.take_along_axis(win, _host(bf.k1_sub).astype(np.int64), axis=1)
    u1 = np.take_along_axis(t1, _host(bf.k1_lane).astype(np.int64), axis=2)
    mid = np.ascontiguousarray(
        u1.reshape(P, WIN).T).reshape(P, SUB, LANES)        # T1
    t2 = np.take_along_axis(mid, _host(bf.k2_sub).astype(np.int64), axis=1)
    z1 = np.take_along_axis(t2, _host(bf.k2_lane).astype(np.int64), axis=2)
    z = np.ascontiguousarray(z1.reshape(P, WIN).T).ravel()  # T2
    F = bf.stack
    NR = n_pad // LANES
    st = z[: NR * SUB * F * LANES].reshape(NR, SUB * F, LANES)
    W = bf.width
    ss3 = _host(bf.k3_sub).reshape(W, NR, LANES).astype(np.int64)
    li3 = _host(bf.k3_lane).reshape(W, NR, LANES).astype(np.int64)
    v3 = _host(bf.k3_vals).reshape(W, NR, LANES)
    iN = np.arange(NR)[:, None, None]
    iL = np.arange(LANES)[None, None, :]
    t3 = st[iN, ss3.transpose(1, 0, 2), iL]                 # [NR, W, 128]
    xg = np.take_along_axis(t3, li3.transpose(1, 0, 2), axis=2)
    y = (v3.transpose(1, 0, 2) * xg).sum(axis=1).ravel()
    tvr = _host(bf.tail_vals).ravel()
    np.add.at(y, _host(bf.tail_rows).ravel(),
              tvr * xp[_host(bf.tail_cols).ravel()])
    return y[: bf.n_rows]
