"""Chebyshev polynomial preconditioning, right-preconditioned (counterpart
of mpi_bicgstab_tpu/ops/cheby.py).

A degree-d Chebyshev polynomial p(A) ~ A^-1 on a spectral interval
[lo, hi]: applying it is d SpMVs and vector updates, no triangular
solve. The solver sees the operator v -> A p(A) v and solves
(A p(A)) y = b; x = p(A) y is applied once at exit (api.solve). Every
residual the solver computes (history, final_relres, the true-residual
gate's b - A p(A) y) is therefore the original system's.

Bounds: `estimate_bounds` takes hi from the Gershgorin row bound of the
host CSR and lo = hi 1e-4, each rounded to 3 significant digits, as in
the JAX package. The coefficient recurrence runs in host float64
(_coeffs); a DF application takes full-precision DF coefficients
(df_const).

Routes of ChebyOperator.apply (x = p(A) v):
  - a float32 DiaMatrix: the whole chain as one kernel launch,
    ops/cuda_cheby.cheby_chain (TPU kernel 29);
  - a DF DiaMatrix: ops/cuda_cheby.cheby_chain_df (TPU kernel 30);
  - float64, ELL and hybrid operators: cheby_apply over layout.spmv (on
    the card the f64 chain rides the float64 DIA SpMV kernel). The JAX
    package has no chain kernel for those either.
The chain kernels take every square DiaMatrix: this port copies neither
the JAX kernels' VMEM budget nor their 2x window-efficiency gate
(pallas_cheby.py:68-102), which describe a TPU window and would refuse
degree 8 on the 1.6M-row generators.

Classic family only: p(A) does not commute with the shift structure of
the shifted solvers.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mpi_bicgstab_tpu_torch.ops.precision import DF, is_df, vfma, vzeros_like


def _round_sig(x: float, sig: int = 3) -> float:
    if x == 0 or not math.isfinite(x):
        return float(x)
    return float(round(x, sig - 1 - int(math.floor(math.log10(abs(x))))))


def estimate_bounds(csr) -> tuple[float, float]:
    """(lo, hi) spectral-interval estimate from the host CSR matrix:
    hi = max Gershgorin row bound (sum of |row|), lo = hi * 1e-4."""
    rows = np.repeat(np.arange(csr.nrows, dtype=np.int64), csr.row_lengths)
    rowabs = np.zeros(csr.nrows)
    np.add.at(rowabs, rows, np.abs(csr.val))
    hi = float(rowabs.max())
    if not (hi > 0 and math.isfinite(hi)):
        raise ValueError("cannot bound the spectrum of an empty/non-"
                         "finite matrix")
    return _round_sig(hi * 1e-4), _round_sig(hi)


@dataclasses.dataclass(frozen=True)
class ChebyPrecond:
    """Preconditioner spec.

    degree: polynomial degree d >= 1 (d SpMVs per application; to
            disable preconditioning, pass no precond at all)
    lo/hi:  spectral bounds; 0.0 = estimate from the matrix (resolve)
    """

    degree: int = 8
    lo: float = 0.0
    hi: float = 0.0

    def __post_init__(self):
        if self.degree < 1:
            raise ValueError(
                "ChebyPrecond degree must be >= 1 (degree 0 would wrap "
                "the operator in a pure scaling that costs an extra SpMV "
                "per application and changes nothing; omit the precond "
                "instead)")

    @staticmethod
    def parse(spec: str) -> "ChebyPrecond | None":
        """'none' | 'cheby' | 'cheby:D' | 'cheby:D:LO:HI' (CLI form)."""
        if spec in ("none", "", None):
            return None
        parts = spec.split(":")
        if parts[0] != "cheby":
            raise ValueError(f"unknown preconditioner {spec!r} "
                             "(choose none or cheby[:degree[:lo:hi]])")
        d = int(parts[1]) if len(parts) > 1 else 8
        lo = float(parts[2]) if len(parts) > 2 else 0.0
        hi = float(parts[3]) if len(parts) > 3 else 0.0
        return ChebyPrecond(degree=d, lo=lo, hi=hi)

    def resolve(self, csr=None) -> "ChebyPrecond":
        """Fill in missing bounds from the matrix (host CSR)."""
        if self.lo > 0 and self.hi > 0:
            return self
        if csr is None:
            raise ValueError("Chebyshev bounds not set and no host matrix "
                             "to estimate them from; pass "
                             "ChebyPrecond(lo=..., hi=...)")
        lo, hi = estimate_bounds(csr)
        return ChebyPrecond(degree=self.degree,
                            lo=self.lo if self.lo > 0 else lo,
                            hi=self.hi if self.hi > 0 else hi)


def _coeffs(degree: int, lo: float, hi: float):
    """Host float64 Chebyshev-iteration coefficients.

    Returns (inv_theta, [(c_d, c_r)] * degree) for the recurrence
        x_0 = v / theta;  r_0 = v - A x_0;  d_0 = r_0 / theta
        x_{k+1} = x_k + d_k
        r_{k+1} = r_k - A d_k
        d_{k+1} = c_d^k d_k + c_r^k r_{k+1}
    """
    if not (0.0 < lo < hi):
        raise ValueError(f"Chebyshev bounds need 0 < lo < hi, got "
                         f"[{lo}, {hi}]")
    theta = (hi + lo) / 2.0
    delta = (hi - lo) / 2.0
    sigma1 = theta / delta
    rho_old = 1.0 / sigma1
    pairs = []
    for _ in range(degree):
        rho = 1.0 / (2.0 * sigma1 - rho_old)
        pairs.append((rho * rho_old, 2.0 * rho / delta))
        rho_old = rho
    return 1.0 / theta, pairs


def split_const(c: float) -> tuple[float, float]:
    """A host float64 as the float32 pair (hi, lo) of a full-precision DF
    constant: hi = f32(c), lo = f32(c - hi)."""
    hi = float(np.float32(c))
    return hi, float(np.float32(c - hi))


def df_const(c: float, device) -> DF:
    """A host float64 as a 0-d DF pair on `device` (made with fills, not
    copied from the host, so that a CUDA graph can capture it). A DF(f32(c),
    0) coefficient would round the polynomial at 2^-24."""
    hi, lo = split_const(c)
    return DF(torch.full((), hi, dtype=torch.float32, device=device),
              torch.full((), lo, dtype=torch.float32, device=device))


def _scale(c, v):
    if is_df(v):
        return vfma(vzeros_like(v), c, v)
    return c * v


def cheby_apply(spmv_fn, v, degree: int, lo: float, hi: float):
    """x ~= A^-1 v by `degree` Chebyshev iteration steps on [lo, hi]
    (`degree` spmv_fn calls; float32, float64 or DF pairs) in the JAX
    package's expression order (ops/cheby.py:169-186): the twin of the
    chain kernels when spmv_fn is their SpMV's twin. x_d needs d_{d-1}
    but never r_d or d_d, so the last step's SpMV and updates are left
    out (the JAX loop makes them and drops them): x is the same bits."""
    inv_theta, pairs = _coeffs(degree, lo, hi)
    if is_df(v):
        inv_theta = df_const(inv_theta, v.device)
        pairs = [(df_const(c_d, v.device), df_const(c_r, v.device))
                 for c_d, c_r in pairs]
    x = _scale(inv_theta, v)
    r = vfma(v, -1.0, spmv_fn(x))
    d = _scale(inv_theta, r)
    for c_d, c_r in pairs[:-1]:
        x = vfma(x, 1.0, d)
        r = vfma(r, -1.0, spmv_fn(d))
        d = vfma(_scale(c_d, d), c_r, r)
    return vfma(x, 1.0, d)


@dataclasses.dataclass(frozen=True)
class ChebyOperator:
    """Right-preconditioned operator v -> A p(A) v over a device layout
    `op` (ops/layout.spmv dispatches on this type)."""

    op: object
    degree: int
    lo: float
    hi: float

    @property
    def shape(self):
        return self.op.shape

    @property
    def n_rows(self):
        return self.op.n_rows

    @property
    def dtype(self):
        return self.op.dtype

    @property
    def device(self):
        return self.op.device

    def apply(self, v):
        """x = p(A) v, the exit transform of a right-preconditioned solve
        (module doc for the routes)."""
        from mpi_bicgstab_tpu_torch.ops import cuda_cheby
        from mpi_bicgstab_tpu_torch.ops.layout import spmv
        op = self.op
        if cuda_cheby.format_ok(op, v.dtype, self.degree):
            chain = cuda_cheby.cheby_chain_df if is_df(op.vals) \
                else cuda_cheby.cheby_chain
            return chain(op.vals, v, op.offsets, self.degree, self.lo,
                         self.hi)
        return cheby_apply(lambda u: spmv(op, u), v, self.degree, self.lo,
                           self.hi)


def wrap_operator(A, prec: ChebyPrecond, csr=None) -> ChebyOperator:
    p = prec.resolve(csr)
    return ChebyOperator(op=A, degree=int(p.degree), lo=float(p.lo),
                         hi=float(p.hi))


def precond_spmv(cb: ChebyOperator, x):
    """y = A p(A) x (the operator the classic solvers iterate on)."""
    from mpi_bicgstab_tpu_torch.ops.layout import spmv
    return spmv(cb.op, cb.apply(x))
