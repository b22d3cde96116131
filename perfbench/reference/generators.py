"""Frozen copies of the arithmetic of the program's matrix generators.

The benchmark's yardstick must not move when the program moves, so the
matrices the check judges against are worked out here again from the
seed, in float64 NumPy, with nothing imported from the program. Each
generator returns the matrix as its diagonals, in the order the
generator draws them: (n, offsets, values), where values[k] holds the
n - |offsets[k]| entries of diagonal offsets[k], entry i of it at
(i, i + o) for o >= 0 and at (i - o, i) for o < 0 (the smaller of row
and column indexes it). `dia_to_csr` assembles those diagonals into CSR
arrays as the program's `_dia_to_csr` does, so that a test can hold the
two matrices equal bit for bit.
"""
from __future__ import annotations

import numpy as np


def transport_hard(n: int = 1_602_112, seed: int = 0, gamma: float = 0.9,
                   theta: float = 25.0, conv: tuple = (0.6, 0.3, 0.15),
                   skew: float = 0.2, rot: tuple = (0.0, 0.0, 0.0)):
    """The m^3-row (m = round(n^(1/3))) 13-diagonal Transport-profile
    matrix: per axis K + theta K^2 (K = tridiag(-1, 2, -1)), upwind
    convection `conv`, a seeded skew perturbation on the +/-1 pairs,
    centred convection `rot` and the shift -gamma lambda_min."""
    m = int(round(n ** (1 / 3)))
    if m < 5:
        raise ValueError("transport_hard needs n >= 125")
    N = m * m * m
    w = m
    alpha = 1.0
    rng = np.random.default_rng(seed)
    idx = np.arange(N, dtype=np.int64)
    x = idx % w
    y = (idx // w) % w
    z = idx // (w * w)
    kap1 = 4.0 * np.sin(np.pi / (2.0 * (m + 1))) ** 2
    cx, cy, cz = conv
    lam_min = (3.0 * alpha + 0.5 * (cx + cy + cz)) * kap1 \
        + 3.0 * theta * kap1 * kap1
    diag = np.zeros(N)
    for pos in (x, y, z):
        diag += 2 * alpha + 6 * theta \
            - theta * ((pos == 0) | (pos == w - 1))
    diag += cx + cy + cz - gamma * lam_min

    offs, vals = [0], [diag]
    off1 = -(alpha + 4 * theta)
    rx, ry, rz = rot
    for pos, step, c, r in ((x, 1, cx, rx), (y, w, cy, ry),
                            (z, w * w, cz, rz)):
        e = skew * rng.uniform(-1.0, 1.0, N - step) + r
        up_ok = pos[: N - step] < w - 1
        vals.append(np.where(up_ok, off1 + e, 0.0))
        offs.append(step)
        vals.append(np.where(up_ok, off1 - c - e, 0.0))
        offs.append(-step)
        up2 = pos[: N - 2 * step] < w - 2
        vals.append(np.where(up2, theta, 0.0))
        offs.append(2 * step)
        vals.append(np.where(up2, theta, 0.0))
        offs.append(-2 * step)
    return N, offs, vals


def banded_random(n: int, offsets, seed: int = 0, diag_boost: float = 1.0):
    """Uniform(-1, 1) values on the band `offsets`, drawn in their order;
    the main diagonal diag_boost + the row's sum of |off-diagonals|."""
    rng = np.random.default_rng(seed)
    offsets = [int(o) for o in offsets]
    if 0 not in offsets:
        offsets = [0] + offsets
    row_abs = np.zeros(n)
    entries = []
    for off in offsets:
        if off == 0:
            continue
        size = n - abs(off)
        v = rng.uniform(-1.0, 1.0, size)
        entries.append((off, v))
        if off > 0:
            row_abs[:size] += np.abs(v)
        else:
            row_abs[-off:] += np.abs(v)
    main = diag_boost + row_abs
    return n, [0] + [o for o, _ in entries], [main] + [v for _, v in entries]


def transport_like(n: int = 1_602_112, seed: int = 0):
    """The 15-diagonal Transport-sized band (w = round(n^(1/3)))."""
    w = int(round(n ** (1 / 3)))
    offsets = [1, -1, 2, -2, w, -w, w + 1, -(w + 1), w * w, -(w * w),
               w * w + w, -(w * w + w), w * w + w + 1, -(w * w + w + 1)]
    offsets = [o for o in offsets if abs(o) < n]
    return banded_random(n, offsets, seed=seed, diag_boost=1.0)


GENERATORS = {"transport_hard": transport_hard,
              "transport_like": transport_like}


def dia_to_csr(n: int, offsets, values):
    """(ptr, col, val) of the square matrix with these diagonals, rows in
    order and each row's entries in increasing column order, every
    position of every diagonal stored (a 0.0 too). Offsets are unique."""
    order = np.argsort(offsets, kind="stable")
    offs = np.asarray(offsets, dtype=np.int64)[order]
    if (np.diff(offs) == 0).any():
        raise ValueError("duplicate diagonal offsets")
    rows = np.arange(n, dtype=np.int64)
    n_lo = np.searchsorted(offs, -rows, side="left")
    n_hi = offs.size - np.searchsorted(offs, n - 1 - rows, side="right")
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(offs.size - n_lo - n_hi, out=ptr[1:])
    col = np.empty(int(ptr[-1]), dtype=np.int64)
    val = np.empty(int(ptr[-1]), dtype=np.float64)
    for w, o in enumerate(offs.tolist()):
        r = (np.arange(0, n - o, dtype=np.int64) if o >= 0
             else np.arange(-o, n, dtype=np.int64))
        pos = ptr[r] + (w - n_lo[r])
        col[pos] = r + o
        val[pos] = values[order[w]]
    return ptr, col, val
