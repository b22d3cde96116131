"""Device-operator construction (counterpart of
mpi_bicgstab_tpu/ops/layout.py).

    build_operator(csr, format='auto') ->
        DiaMatrix            (fully diagonal-structured)
        HybridMatrix         (DIA majority + ELL remainder)
        WindowEllMatrix      (unstructured with column locality)
        EllMatrix            (format='ell')

and the generic `spmv(op, x)` the solvers use, on tensors or, for an
operator built with dtype="df32", on double-float pairs (ops/precision.DF);
on a Chebyshev-wrapped operator (ops/cheby.ChebyOperator) it is the
right-preconditioned product A p(A) x.
The butterfly layout, which the JAX package's 'auto' picks for a matrix
with under half its nonzeros on diagonals and no window locality, is
ROADMAP slice 6c; until then those requests raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses

from mpi_bicgstab_tpu_torch.ops.cheby import ChebyOperator, precond_spmv
from mpi_bicgstab_tpu_torch.ops.dia import (DiaMatrix, analyze_diagonals,
                                            csr_to_dia, dia_spmv)
from mpi_bicgstab_tpu_torch.ops.ell import EllMatrix, csr_to_ell
from mpi_bicgstab_tpu_torch.ops.precision import df_add, is_df
from mpi_bicgstab_tpu_torch.ops.spmv import ell_spmv, ell_spmv_df
from mpi_bicgstab_tpu_torch.ops.window_ell import (WindowEllMatrix,
                                                   csr_to_window_ell,
                                                   window_ell_stats)
from mpi_bicgstab_tpu_torch.ops.window_spmv import window_spmv, window_spmv_df

_SLICE6C = "ROADMAP slice 6c (the butterfly layout)"


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
                 they cover >= 50%; else windowed-ELL when n % 1024 == 0
                 and >= 95% of the nonzeros lie in their row tile's
                 1024-column window (and the build takes it); else the
                 JAX package's butterfly layout (slice 6c: raises)
      'dia' / 'hybrid' — DIA, plus an ELL remainder if any
      'window' — windowed-ELL (ops/window_ell.py; n % 1024 == 0)
      'ell'    — gather-ELL (the layout closest to the reference's CSR)
      'butterfly' — slice 6c: raises NotImplementedError
    """
    if format not in ("auto", "dia", "ell", "hybrid", "window",
                      "butterfly"):
        raise ValueError(f"unknown format {format!r}")
    route, offsets = (auto_route(csr, max_diags, dia_min_fill)
                      if format == "auto" else (format, None))
    if route == "window":
        try:
            return csr_to_window_ell(csr, dtype=dtype, device=device)
        except ValueError:
            if format != "auto":
                raise
            route = "butterfly"     # hub rows overflow the tail levels
    if route == "butterfly":
        raise NotImplementedError(butterfly_refusal(format))
    if route == "ell":
        return csr_to_ell(csr, width=ell_width, dtype=dtype, device=device)
    if offsets is None:
        offsets, _ = analyze_diagonals(csr, max_diags=max_diags,
                                       min_fill=dia_min_fill)
    dia, remainder = csr_to_dia(csr, offsets, dtype=dtype, device=device)
    if remainder is None:
        return dia
    ell = csr_to_ell(remainder, width=ell_width, dtype=dtype, device=device)
    return HybridMatrix(dia, ell)


def auto_route(csr, max_diags: int = 64, dia_min_fill: float = 0.02):
    """(route, offsets): the layout 'auto' builds for this matrix, by the
    JAX package's rule (mpi_bicgstab_tpu/ops/layout.py), and the diagonal
    offsets the analysis found. route is 'hybrid' (DIA, plus an ELL
    remainder if any) when the top diagonals hold >= 50% of the nonzeros;
    else 'window' when n % 1024 == 0 and >= 95% of the nonzeros lie in
    their row tile's window; else 'butterfly'. A window build that
    spills too deep still falls through to 'butterfly' (build_operator)."""
    offsets, coverage = analyze_diagonals(csr, max_diags=max_diags,
                                          min_fill=dia_min_fill)
    if offsets and coverage >= 0.5:
        return "hybrid", offsets
    if (csr.nrows % 1024 == 0
            and window_ell_stats(csr)["window_frac"] >= 0.95):
        return "window", offsets
    return "butterfly", offsets


def butterfly_refusal(format: str) -> str:
    """Why a matrix routed to the butterfly layout is refused."""
    what = ("format 'butterfly' is" if format == "butterfly" else
            f"format {format!r} routes this matrix (under half its "
            f"nonzeros on diagonals, too little window locality) to the "
            f"butterfly layout, which is")
    return f"{what} not ported yet: {_SLICE6C}; pass format='ell' " \
           f"(CLI: --format ell)"


def spmv(op, x):
    """Generic y = op @ x over any ported layout (DF values take the DF
    SpMVs, as in the JAX package)."""
    if isinstance(op, ChebyOperator):
        return precond_spmv(op, x)       # y = A p(A) x (ops/cheby.py)
    if isinstance(op, DiaMatrix):
        return dia_spmv(op, x)
    if isinstance(op, EllMatrix):
        return ell_spmv_df(op, x) if is_df(op.vals) else ell_spmv(op, x)
    if isinstance(op, WindowEllMatrix):
        return (window_spmv_df(op, x) if is_df(op.vals)
                else window_spmv(op, x))
    if isinstance(op, HybridMatrix):
        if is_df(op.dia.vals):
            return df_add(dia_spmv(op.dia, x), ell_spmv_df(op.ell, x))
        return dia_spmv(op.dia, x) + ell_spmv(op.ell, x)
    raise TypeError(f"not a device sparse operator: {type(op)}")
