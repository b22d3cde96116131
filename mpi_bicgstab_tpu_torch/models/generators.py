"""Test / benchmark matrix generators (counterpart of
mpi_bicgstab_tpu/models/generators.py; the same seed gives bit-identical
arrays).

The reference ships no matrices and benchmarks on SuiteSparse
Transport.mtx (1,602,111 rows, 23,487,281 nnz, ~14.7 nnz/row, real
unsymmetric values on a structurally symmetric pattern). These
generators synthesise matrices with matching profiles:

* poisson2d / poisson3d — classic stencils, well conditioned.
* banded_random / transport_like — a fixed band with random unsymmetric
  values and a dominant main diagonal; transport_like matches
  Transport's size and density.
* transport_hard — the Transport profile with a convergence rate in the
  reference's regime (thousands of iterations).
* banded_tough — banded_random made sub-dominant: long, erratic
  convergence.
* clustered_random — unstructured but clustered: each 1024-row block's
  columns fall in its own 1024-column block, plus a few long-range
  entries (the windowed-ELL layout's matrix).
* skew_banded — a skew-dominant operator (conjugate-pair spectrum) on
  which the classic family fails and BiCGStab(l) converges.
* random_diag_dominant — uniform random columns, no locality at any
  permutation (the butterfly layout's matrix).
"""
from __future__ import annotations

import numpy as np

from mpi_bicgstab_tpu_torch.ops.sparse import COOMatrix, CSRMatrix, coo_to_csr


def _dia_to_csr(n: int, offsets, diag_vals) -> CSRMatrix:
    """Assemble a square matrix from (offset, values) diagonals.

    For unique offsets the CSR structure is analytic (row i holds the
    offsets o with 0 <= i+o < n, in offset order), so no COO staging or
    sort is needed."""
    order = np.argsort(offsets, kind="stable")
    offs = np.asarray(offsets, dtype=np.int64)[order]
    if offs.size and (np.diff(offs) == 0).any():
        # duplicate offsets: the general COO path sums them
        rows_l, cols_l, vals_l = [], [], []
        for off, dv in zip(offsets, diag_vals):
            r = (np.arange(0, n - off, dtype=np.int64) if off >= 0
                 else np.arange(-off, n, dtype=np.int64))
            rows_l.append(r)
            cols_l.append(r + off)
            v = dv if np.ndim(dv) else np.full(r.size, dv)
            vals_l.append(np.asarray(v, dtype=np.float64)[: r.size])
        coo = COOMatrix(np.concatenate(rows_l), np.concatenate(cols_l),
                        np.concatenate(vals_l), (n, n))
        return coo_to_csr(coo, sum_duplicates=True)

    dvals = [diag_vals[k] for k in order]
    rows = np.arange(n, dtype=np.int64)
    # offsets invalid at row i: o < -i (a prefix of offs) or o > n-1-i
    # (a suffix), counted with searchsorted over the sorted offsets
    n_lo = np.searchsorted(offs, -rows, side="left")
    n_hi = offs.size - np.searchsorted(offs, n - 1 - rows, side="right")
    lengths = offs.size - n_lo - n_hi
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=ptr[1:])
    nnz = int(ptr[-1])
    col = np.empty(nnz, dtype=np.int64)
    val = np.empty(nnz, dtype=np.float64)
    for w, (o, dv) in enumerate(zip(offs.tolist(), dvals)):
        r = (np.arange(0, n - o, dtype=np.int64) if o >= 0
             else np.arange(-o, n, dtype=np.int64))
        pos = ptr[r] + (w - n_lo[r])
        col[pos] = r + o
        v = dv if np.ndim(dv) else np.full(r.size, dv)
        val[pos] = np.asarray(v, dtype=np.float64)[: r.size]
    return CSRMatrix(ptr, col, val, (n, n))


def poisson2d(nx: int, ny: int | None = None) -> CSRMatrix:
    """5-point Laplacian on an nx x ny grid (SPD, 4 on the diagonal)."""
    ny = ny or nx
    n = nx * ny
    main = np.full(n, 4.0)
    ew = -np.ones(n - 1)
    ew[np.arange(1, n) % nx == 0] = 0.0  # no wrap across grid rows
    ns = -np.ones(n - nx)
    return _dia_to_csr(n, [0, 1, -1, nx, -nx],
                       [main, ew, ew.copy(), ns, ns.copy()])


def poisson3d(nx: int, ny: int | None = None,
              nz: int | None = None) -> CSRMatrix:
    """7-point Laplacian on an nx x ny x nz grid."""
    ny = ny or nx
    nz = nz or nx
    n = nx * ny * nz
    main = np.full(n, 6.0)
    ex = -np.ones(n - 1)
    ex[np.arange(1, n) % nx == 0] = 0.0
    ey = -np.ones(n - nx)
    ey[(np.arange(nx, n) // nx) % ny == 0] = 0.0
    ez = -np.ones(n - nx * ny)
    return _dia_to_csr(n, [0, 1, -1, nx, -nx, nx * ny, -nx * ny],
                       [main, ex, ex.copy(), ey, ey.copy(), ez, ez.copy()])


def banded_random(n: int, offsets, seed: int = 0,
                  diag_boost: float = 1.0) -> CSRMatrix:
    """Unsymmetric values on a fixed band; the main diagonal is
    diag_boost + (sum of |off-diagonals| in the row), so the matrix is
    strictly diagonally dominant and BiCGStab converges on it."""
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
        if off > 0:  # rows [0, size)
            row_abs[:size] += np.abs(v)
        else:
            row_abs[-off:] += np.abs(v)
    main = diag_boost + row_abs
    offs = [0] + [o for o, _ in entries]
    vals = [main] + [v for _, v in entries]
    return _dia_to_csr(n, offs, vals)


def random_diag_dominant(n: int, nnz_per_row: int = 8,
                         seed: int = 0) -> CSRMatrix:
    """Random sparsity pattern (not banded), strictly diagonally dominant:
    nnz_per_row - 1 uniform random columns per row plus the diagonal,
    1 + the row's absolute off-diagonal sum (duplicates summed)."""
    rng = np.random.default_rng(seed)
    k = max(1, nnz_per_row - 1)
    cols = rng.integers(0, n, size=(n, k))
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    vals = rng.uniform(-1.0, 1.0, size=n * k)
    rows_all = np.concatenate([rows, np.arange(n, dtype=np.int64)])
    cols_all = np.concatenate([cols.ravel(), np.arange(n, dtype=np.int64)])
    row_abs = np.abs(vals).reshape(n, k).sum(axis=1)
    vals_all = np.concatenate([vals, 1.0 + row_abs])
    coo = COOMatrix(rows_all, cols_all, vals_all, (n, n))
    return coo_to_csr(coo, sum_duplicates=True)


def banded_tough(n: int, offsets, seed: int = 0,
                 dominance: float = 0.46) -> CSRMatrix:
    """Like banded_random but sub-dominant: the main diagonal is
    dominance * (row off-diagonal mass) + 0.05, so BiCGStab shows the
    reference's long, erratic convergence. Around dominance 0.45-0.5 the
    iteration count sweeps from ~80 to ~6,000 (JAX package, n = 40k)."""
    rng = np.random.default_rng(seed)
    offsets = [int(o) for o in offsets if o != 0]
    entries = []
    row_abs = np.zeros(n)
    for off in offsets:
        size = n - abs(off)
        v = rng.uniform(-1.0, 1.0, size)
        entries.append((off, v))
        if off > 0:
            row_abs[:size] += np.abs(v)
        else:
            row_abs[-off:] += np.abs(v)
    main = dominance * row_abs + 0.05
    offs = [0] + [o for o, _ in entries]
    vals = [main] + [v for _, v in entries]
    return _dia_to_csr(n, offs, vals)


def transport_hard(n: int = 1_602_112, seed: int = 0,
                   gamma: float = 0.9, theta: float = 25.0,
                   conv: tuple = (0.6, 0.3, 0.15),
                   skew: float = 0.2,
                   rot: tuple = (0.0, 0.0, 0.0)) -> CSRMatrix:
    """Transport-profile matrix on which BiCGStab needs thousands of
    iterations, with a positive definite symmetric part (slow Krylov
    convergence, no breakdown).

    Per axis the 1-D operator K + theta*K^2 (K = tridiag(-1,2,-1)), the
    3-D Kronecker sum of three of them (13 diagonals), upwind convection
    `conv` per axis, a random skew-symmetric perturbation `skew` on the
    +/-1 pairs (seeded), centred convection `rot` per axis, and a
    diagonal shift -gamma*lambda_min. theta is the iteration dial.
    Returns an m^3-row matrix with m = round(n^(1/3))."""
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
    # exact lambda_min of sym(A): upwind convection's symmetric part is
    # (c/2)K per axis, so sym(A) = sum_d [(alpha + c_d/2) K + theta K^2]
    lam_min = (3.0 * alpha + 0.5 * (cx + cy + cz)) * kap1 \
        + 3.0 * theta * kap1 * kap1
    # main diagonal: per axis 2a+6t inside, 2a+5t at the two ends, plus
    # upwind convection, minus the spectral-gap shift
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
        # +step: element j <-> entry (j, j+step); valid pos[j] < w-1
        up_ok = pos[: N - step] < w - 1
        vals.append(np.where(up_ok, off1 + e, 0.0))
        offs.append(step)
        # -step: element j <-> entry (j+step, j); upwind side gets -c
        vals.append(np.where(up_ok, off1 - c - e, 0.0))
        offs.append(-step)
        # +/-2*step: the theta*K^2 outer band, valid pos within 2
        up2 = pos[: N - 2 * step] < w - 2
        vals.append(np.where(up2, theta, 0.0))
        offs.append(2 * step)
        vals.append(np.where(up2, theta, 0.0))
        offs.append(-2 * step)
    return _dia_to_csr(N, offs, vals)


def transport_like(n: int = 1_602_112, seed: int = 0) -> CSRMatrix:
    """Benchmark matrix profiled on SuiteSparse Transport: ~1.6M rows,
    ~14.7 nnz/row as a 15-diagonal band (structurally symmetric offsets,
    unsymmetric values), diagonally dominant; nnz ~= 15*n."""
    w = int(round(n ** (1 / 3)))
    offsets = [1, -1, 2, -2, w, -w, w + 1, -(w + 1), w * w, -(w * w),
               w * w + w, -(w * w + w), w * w + w + 1, -(w * w + w + 1)]
    offsets = [o for o in offsets if abs(o) < n]
    return banded_random(n, offsets, seed=seed, diag_boost=1.0)


def clustered_random(n: int, nnz_per_row: int = 8, seed: int = 0,
                     global_frac: float = 0.003) -> CSRMatrix:
    """Unstructured-but-CLUSTERED sparsity: each 1024-row block draws
    its columns uniformly at random WITHIN its own 1024-column block,
    plus a `global_frac` fraction of long-range entries anywhere —
    the sparsity profile of partitioned FEM meshes / community graphs.

    Not bandable: within a block the pattern is uniform random over
    ~1024 distinct diagonals, so no permutation (RCM included) exposes
    a DIA structure, yet ops/window_ell.py captures >= 99% of the
    nonzeros in per-tile windows. The benchmark matrix of the
    windowed-ELL layout; diagonally dominant, so the solvers converge
    on it. n must be a multiple of 1024."""
    if n % 1024:
        raise ValueError("clustered_random needs n % 1024 == 0")
    rng = np.random.default_rng(seed)
    k = max(1, nnz_per_row - 1)
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    block = rows // 1024
    local = rng.integers(0, 1024, size=n * k)
    cols = block * 1024 + local
    n_glob = int(global_frac * n * k)
    if n_glob:
        pick = rng.choice(n * k, size=n_glob, replace=False)
        cols[pick] = rng.integers(0, n, size=n_glob)
    vals = rng.uniform(-1.0, 1.0, size=n * k)
    rows_all = np.concatenate([rows, np.arange(n, dtype=np.int64)])
    cols_all = np.concatenate([cols, np.arange(n, dtype=np.int64)])
    row_abs = np.abs(vals).reshape(n, k).sum(axis=1)
    vals_all = np.concatenate([vals, 1.0 + row_abs])
    coo = COOMatrix(rows_all, cols_all, vals_all, (n, n))
    return coo_to_csr(coo, sum_duplicates=True)


def skew_banded(n: int, w: int = 0, diag: float = 0.05,
                seed: int = 0) -> CSRMatrix:
    """Skew-dominant operator A = diag*I + S, S^T = -S, on a +-1, +-w
    band (w = round(n^(1/3)) by default): eigenvalues diag +- i s_k. The
    classic family's degree-1 real stabiliser cannot damp conjugate
    pairs, so it stagnates or diverges; BiCGStab(l >= 2) converges.
    Models convection-dominated transport."""
    rng = np.random.default_rng(seed)
    w = w or max(2, int(round(n ** (1 / 3))))
    rows = [np.arange(n, dtype=np.int64)]
    cols = [np.arange(n, dtype=np.int64)]
    vals = [np.full(n, diag)]
    for off in (1, w):
        if off >= n:
            continue
        size = n - off
        v = rng.uniform(0.5, 1.5, size)
        i = np.arange(size, dtype=np.int64)
        rows += [i, i + off]
        cols += [i + off, i]
        vals += [v, -v]          # S[i, i+off] = v, S[i+off, i] = -v
    coo = COOMatrix(np.concatenate(rows), np.concatenate(cols),
                    np.concatenate(vals), (n, n))
    return coo_to_csr(coo)
