"""Problem construction mirroring the reference's main programs
(counterpart of mpi_bicgstab_tpu/models/problem.py).

Every reference main program builds the right-hand side so that the
exact solution is all-ones, b = A*1 (main.c:109-117), with x0 = 0; ||x - 1||
at the end is a free ground-truth check.

Padding: pad_csr_identity extends A with identity rows (A[i,i] = 1 for
i >= n) whose right-hand side is 0, so the padded solution components
are exactly 0 and never perturb dots or residuals. The port's DIA and
ELL kernels need no padding (multiple=1); the windowed-ELL layout needs
n % 1024 == 0 (the CLI pads to 1024 for it, as the JAX CLI pads every
problem).

Reordering: build_problem(reorder=...) applies the RCM permutation of
ops/reorder.py before the layout analysis; Problem.perm keeps it and
Problem.unpermute maps a solution back to the original row order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpi_bicgstab_tpu_torch.ops.dia import is_df32
from mpi_bicgstab_tpu_torch.ops.precision import df_from_f64, vzeros_like
from mpi_bicgstab_tpu_torch.ops.reorder import maybe_reorder, unpermute_vector
from mpi_bicgstab_tpu_torch.ops.sparse import CSRMatrix
from mpi_bicgstab_tpu_torch.utils.config import canon_dtype
from mpi_bicgstab_tpu_torch.utils.device import resolve_device


def pad_csr_identity(csr: CSRMatrix, multiple: int) -> CSRMatrix:
    """Pad a square CSR to ceil(n/multiple)*multiple rows/cols with 1.0
    identity rows. Returns csr unchanged if already aligned."""
    n = csr.nrows
    n_pad = -(-n // multiple) * multiple
    if n_pad == n:
        return csr
    extra = n_pad - n
    ptr = np.concatenate([csr.ptr,
                          csr.ptr[-1] + 1 + np.arange(extra, dtype=np.int64)])
    col = np.concatenate([csr.col, np.arange(n, n_pad, dtype=np.int64)])
    val = np.concatenate([csr.val, np.ones(extra, dtype=csr.val.dtype)])
    return CSRMatrix(ptr, col, val, (n_pad, n_pad))


@dataclasses.dataclass
class Problem:
    """A ready-to-solve system: device operator + RHS with known solution."""

    csr: CSRMatrix          # padded host CSR
    A: object               # DiaMatrix / EllMatrix / HybridMatrix
    b: torch.Tensor         # [n_pad]; a DF pair for df32
    x0: torch.Tensor        # zeros, [n_pad]; a DF pair for df32
    n_logical: int          # rows before padding
    perm: np.ndarray | None = None   # RCM permutation (ops/reorder.py)

    @property
    def n(self) -> int:
        return self.csr.nrows

    def exact_solution(self) -> np.ndarray:
        # all-ones is permutation invariant, so this holds under RCM too
        e = np.zeros(self.n)
        e[: self.n_logical] = 1.0
        return e

    def unpermute(self, x_host: np.ndarray) -> np.ndarray:
        """A solution of the (possibly reordered) system in the original
        row order; identity without a reorder. x_host may be [n] or
        batched [..., n]; padded trailing entries stay where they are."""
        if self.perm is None:
            return np.asarray(x_host)
        x = np.asarray(x_host)
        out = x.copy()
        out[..., : self.perm.size] = unpermute_vector(
            x[..., : self.perm.size].T, self.perm).T
        return out


def build_problem(csr: CSRMatrix, dtype=torch.float64, multiple: int = 8,
                  device="cuda", format: str = "auto",
                  ell_width: int | None = None,
                  sigma_seed: float = 0.0, reorder: str = "none",
                  layout_cache: str | None = None) -> Problem:
    """b = (A + sigma_seed I) * ones (ones over the logical rows only; the
    shifted drivers' right-hand side, main_shifted.c:109-114), computed on
    the host in float64 and cast to dtype; the operator and vectors go to `device`
    (default the card; raises without one). format selects the layout
    (ops/layout.build_operator). dtype="df32" builds the double-float
    problem: the operator's values, b and x0 are DF pairs
    (ops/precision.DF), split from the float64 host values. reorder:
    'none' | 'rcm' | 'auto', the RCM permutation applied before the
    layout analysis (ops/reorder.maybe_reorder); the Problem carries it
    for unpermute(). layout_cache: the persistent layout cache's
    directory (utils/opcache.py; None takes MBT_LAYOUT_CACHE): a repeat
    build of the same matrix and options loads the layout instead of
    building it on the host."""
    from mpi_bicgstab_tpu_torch.ops.layout import build_operator

    df = is_df32(dtype)          # before canon_dtype, which maps it to f32
    dt = canon_dtype(dtype)
    dev = resolve_device(device)
    csr, perm = maybe_reorder(csr, reorder)
    n_logical = csr.nrows
    csr_p = pad_csr_identity(csr, multiple)
    ones = np.zeros(csr_p.nrows)
    ones[:n_logical] = 1.0
    b_host = csr_p.matvec(ones) + sigma_seed * ones
    b_host[n_logical:] = 0.0  # identity-row RHS: padded solution is 0
    A = build_operator(csr_p, format=format, dtype="df32" if df else dt,
                       ell_width=ell_width, device=dev,
                       cache_dir=layout_cache)
    if df:
        b = df_from_f64(b_host, dev)
    else:
        b = torch.as_tensor(b_host, dtype=dt, device=dev)
    return Problem(csr_p, A, b, vzeros_like(b), n_logical, perm)
