"""Bandwidth-reducing row/column reordering, reverse Cuthill-McKee
(counterpart of mpi_bicgstab_tpu/ops/reorder.py; the same CSR gives the
same permutation and the same permuted arrays).

The fast path is the DIA layout (ops/dia.py), which applies only when the
nonzeros sit on few diagonals. Many real systems (FEM meshes, circuit
matrices) are narrow-band in SOME ordering, just not the one they were
stored in; RCM (Cuthill & McKee 1969, reversed per George 1971) permutes
the matrix symmetrically to pull the entries toward the diagonal.
`maybe_reorder` applies it, and in mode 'auto' only when it moves the
matrix from under half of its nonzeros on diagonals to at least half.

Solving the permuted system: with P the permutation matrix of `perm`
(row i of P A P^T is row perm[i] of A), solve (P A P^T) y = P b, then
x = P^T y (`permute_vector` / `unpermute_vector`). The all-ones known
solution of every driver is permutation invariant (P 1 = 1).
"""
from __future__ import annotations

from collections import deque

import numpy as np

from mpi_bicgstab_tpu_torch.ops.dia import analyze_diagonals
from mpi_bicgstab_tpu_torch.ops.sparse import (COOMatrix, CSRMatrix,
                                               coo_to_csr)


def _symmetric_adjacency(csr: CSRMatrix):
    """ptr/col of the pattern of A | A^T, diagonal dropped."""
    n = csr.nrows
    rows = np.repeat(np.arange(n, dtype=np.int64), csr.row_lengths)
    cols = csr.col
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    off = r != c
    r, c = r[off], c[off]
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    if r.size:
        keep = np.concatenate([[True], (r[1:] != r[:-1]) | (c[1:] != c[:-1])])
        r, c = r[keep], c[keep]
    counts = np.bincount(r, minlength=n)
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    return ptr, c


def rcm_ordering(csr: CSRMatrix) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of A|A^T's pattern.

    Returns perm such that row i of the reordered matrix is row perm[i]
    of the original. Uses scipy's C implementation when available; the
    in-repo BFS below is the dependency-free fallback (identical
    algorithm: min-degree start per component, neighbors visited in
    degree order, final order reversed)."""
    try:
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee
    except ImportError:
        return _rcm_bfs(csr)
    n = csr.nrows
    rows = np.repeat(np.arange(n, dtype=np.int64), csr.row_lengths)
    a = sp.csr_matrix(
        (np.ones(csr.nnz, np.int8), (rows, csr.col)), shape=csr.shape)
    return np.asarray(reverse_cuthill_mckee(a, symmetric_mode=False),
                      dtype=np.int64)


def _rcm_bfs(csr: CSRMatrix) -> np.ndarray:
    """Dependency-free RCM (the scipy-less fallback; also the oracle
    the tests pin the algorithm against)."""
    ptr, col = _symmetric_adjacency(csr)
    n = csr.nrows
    deg = np.diff(ptr)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    deg_order = np.argsort(deg, kind="stable")
    for s in deg_order:
        if visited[s]:
            continue
        visited[s] = True
        q = deque([s])
        while q:
            u = q.popleft()
            order[pos] = u
            pos += 1
            nbrs = col[ptr[u]:ptr[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if nbrs.size:
                nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
                visited[nbrs] = True
                q.extend(nbrs.tolist())
    return order[::-1].copy()


def bandwidth(csr: CSRMatrix, perm: np.ndarray | None = None) -> int:
    """max |col - row| (0 for diagonal/empty); optionally under perm."""
    if csr.nnz == 0:
        return 0
    rows = np.repeat(np.arange(csr.nrows, dtype=np.int64), csr.row_lengths)
    cols = csr.col
    if perm is not None:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.size, dtype=np.int64)
        rows, cols = inv[rows], inv[cols]
    return int(np.abs(cols - rows).max())


def permute_csr(csr: CSRMatrix, perm: np.ndarray) -> CSRMatrix:
    """P A P^T: entry (i, j) moves to (inv[i], inv[j])."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int64)
    rows = np.repeat(np.arange(csr.nrows, dtype=np.int64), csr.row_lengths)
    coo = COOMatrix(inv[rows], inv[csr.col], csr.val.copy(), csr.shape)
    return coo_to_csr(coo)


def permute_vector(v: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """P v — the RHS of the permuted system ((Pv)[i] = v[perm[i]])."""
    return np.asarray(v)[perm]


def unpermute_vector(y: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """P^T y — map the permuted-system solution back ((P^T y)[perm[i]]
    = y[i])."""
    out = np.empty_like(np.asarray(y))
    out[perm] = np.asarray(y)
    return out


def maybe_reorder(csr: CSRMatrix, mode: str = "auto",
                  max_diags: int = 64, dia_min_fill: float = 0.02):
    """Decide and apply RCM. Returns (csr', perm | None).

    mode:
      'none' — never
      'rcm'  — always
      'auto' — only when the natural ordering has under half of its
               nonzeros on diagonals (the unstructured layouts) AND RCM
               concentrates them onto few enough diagonals to change
               that
    """
    if mode == "none":
        return csr, None
    if mode not in ("rcm", "auto"):
        raise ValueError(f"unknown reorder mode {mode!r}")
    if mode == "auto":
        _, coverage = analyze_diagonals(csr, max_diags=max_diags,
                                        min_fill=dia_min_fill)
        if coverage >= 0.5:
            return csr, None            # already routes to DIA/hybrid
    perm = rcm_ordering(csr)
    csr_p = permute_csr(csr, perm)
    if mode == "auto":
        _, cov_p = analyze_diagonals(csr_p, max_diags=max_diags,
                                     min_fill=dia_min_fill)
        if cov_p < 0.5:
            return csr, None            # reordering didn't help; keep
    return csr_p, perm
