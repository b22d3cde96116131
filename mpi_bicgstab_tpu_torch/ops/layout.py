"""Device-operator construction (counterpart of
mpi_bicgstab_tpu/ops/layout.py).

    build_operator(csr, format='auto') ->
        DiaMatrix            (fully diagonal-structured)
        HybridMatrix         (DIA majority + ELL remainder)
        EllMatrix            (format='ell')

and the generic `spmv(op, x)` the solvers use, on tensors or, for an
operator built with dtype="df32", on double-float pairs (ops/precision.DF);
on a Chebyshev-wrapped operator (ops/cheby.ChebyOperator) it is the
right-preconditioned product A p(A) x.
The windowed-ELL and
butterfly layouts, which the JAX package's 'auto' picks for matrices
with less than half their nonzeros on diagonals, are ROADMAP slice 6b;
until then those requests raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses

from mpi_bicgstab_tpu_torch.ops.cheby import ChebyOperator, precond_spmv
from mpi_bicgstab_tpu_torch.ops.dia import (DiaMatrix, analyze_diagonals,
                                            csr_to_dia, dia_spmv)
from mpi_bicgstab_tpu_torch.ops.ell import EllMatrix, csr_to_ell
from mpi_bicgstab_tpu_torch.ops.precision import df_add, is_df
from mpi_bicgstab_tpu_torch.ops.spmv import ell_spmv, ell_spmv_df

_SLICE6 = "ROADMAP slice 6b (unstructured layouts)"


@dataclasses.dataclass(frozen=True)
class HybridMatrix:
    """DIA part + ELL remainder; A = dia + ell."""

    dia: DiaMatrix
    ell: EllMatrix

    @property
    def shape(self):
        return self.dia.shape

    @property
    def n_rows(self):
        return self.dia.n_rows

    @property
    def n_cols(self):
        return self.dia.n_cols

    @property
    def dtype(self):
        return self.dia.dtype

    @property
    def device(self):
        return self.dia.device


def build_operator(csr, format: str = "auto", dtype=None,
                   max_diags: int = 64, dia_min_fill: float = 0.02,
                   ell_width: int | None = None, device="cuda"):
    """Pick and build the device layout for a square CSR matrix.

    format:
      'auto'   — DIA if the top diagonals cover everything, hybrid if
                 they cover >= 50%; below that the JAX package routes to
                 windowed-ELL or butterfly layouts (slice 6b: raises)
      'dia' / 'hybrid' — DIA, plus an ELL remainder if any
      'ell'    — gather-ELL (the layout closest to the reference's CSR)
      'window', 'butterfly' — slice 6b: raise NotImplementedError
    """
    if format not in ("auto", "dia", "ell", "hybrid", "window",
                      "butterfly"):
        raise ValueError(f"unknown format {format!r}")
    if format in ("window", "butterfly"):
        raise NotImplementedError(
            f"format {format!r} is not ported yet: {_SLICE6}")
    if format == "ell":
        return csr_to_ell(csr, width=ell_width, dtype=dtype, device=device)

    offsets, coverage = analyze_diagonals(csr, max_diags=max_diags,
                                          min_fill=dia_min_fill)
    if format == "auto" and (not offsets or coverage < 0.5):
        raise NotImplementedError(
            f"format 'auto' would route this matrix ({coverage:.1%} of "
            f"nonzeros on {len(offsets)} diagonals) to the windowed-ELL "
            f"or butterfly layout, not ported yet: {_SLICE6}; pass "
            f"format='ell' (CLI: --format ell)")

    dia, remainder = csr_to_dia(csr, offsets, dtype=dtype, device=device)
    if remainder is None:
        return dia
    ell = csr_to_ell(remainder, width=ell_width, dtype=dtype, device=device)
    return HybridMatrix(dia, ell)


def spmv(op, x):
    """Generic y = op @ x over any ported layout (DF values take the DF
    SpMVs, as in the JAX package)."""
    if isinstance(op, ChebyOperator):
        return precond_spmv(op, x)       # y = A p(A) x (ops/cheby.py)
    if isinstance(op, DiaMatrix):
        return dia_spmv(op, x)
    if isinstance(op, EllMatrix):
        return ell_spmv_df(op, x) if is_df(op.vals) else ell_spmv(op, x)
    if isinstance(op, HybridMatrix):
        if is_df(op.dia.vals):
            return df_add(dia_spmv(op.dia, x), ell_spmv_df(op.ell, x))
        return dia_spmv(op.dia, x) + ell_spmv(op.ell, x)
    raise TypeError(f"not a device sparse operator: {type(op)}")
