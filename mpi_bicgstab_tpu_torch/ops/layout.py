"""Device-operator construction (counterpart of
mpi_bicgstab_tpu/ops/layout.py).

    build_operator(csr, format='auto') ->
        DiaMatrix            (fully diagonal-structured)
        HybridMatrix         (DIA majority + ELL remainder)
        WindowEllMatrix      (unstructured with column locality)
        ButterflyMatrix      (unstructured, no locality)
        EllMatrix            (format='ell', or a matrix no other
                              layout takes)

and the generic `spmv(op, x)` the solvers use, on tensors or, for an
operator built with dtype="df32", on double-float pairs (ops/precision.DF);
on a Chebyshev-wrapped operator (ops/cheby.ChebyOperator) it is the
right-preconditioned product A p(A) x.
"""
from __future__ import annotations

import dataclasses
import os

from mpi_bicgstab_tpu_torch.ops import native_route
from mpi_bicgstab_tpu_torch.ops.butterfly import (ButterflyMatrix,
                                                 build_butterfly)
from mpi_bicgstab_tpu_torch.ops.butterfly_spmv import (butterfly_spmv,
                                                       butterfly_spmv_df)
from mpi_bicgstab_tpu_torch.ops.cheby import ChebyOperator, precond_spmv
from mpi_bicgstab_tpu_torch.ops.dia import (DiaMatrix, LayoutRefused,
                                            analyze_diagonals, csr_to_dia,
                                            dia_spmv, host_dtype, is_df32)
from mpi_bicgstab_tpu_torch.ops.ell import EllMatrix, csr_to_ell
from mpi_bicgstab_tpu_torch.ops.precision import DF, df_add, is_df
from mpi_bicgstab_tpu_torch.ops.spmv import ell_spmv, ell_spmv_df
from mpi_bicgstab_tpu_torch.ops.window_ell import (WindowEllMatrix,
                                                   csr_to_window_ell,
                                                   window_ell_stats)
from mpi_bicgstab_tpu_torch.ops.window_spmv import window_spmv, window_spmv_df
from mpi_bicgstab_tpu_torch.utils.device import resolve_device
from mpi_bicgstab_tpu_torch.utils.timing import span


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

# 'auto''s fall-through when a build refuses the matrix (JAX
# ops/layout.py:120-130): a windowed-ELL build whose hub rows overflow the
# tail levels goes on to butterfly, a butterfly build that cannot route
# the matrix (wide rows, dense blocks) to gather-ELL. Only the refusal
# (LayoutRefused) falls through: any other error, such as a kernel's from
# the column table's build on the card, is raised.
FALL_THROUGH = {"window": "butterfly", "butterfly": "ell"}
_BUILDERS = {"window": csr_to_window_ell, "butterfly": build_butterfly}


def build_operator(csr, format: str = "auto", dtype=None,
                   max_diags: int = 64, dia_min_fill: float = 0.02,
                   ell_width: int | None = None, device="cuda",
                   cache_dir: str | None = None):
    """Pick and build the device layout for a square CSR matrix.

    cache_dir: the persistent layout cache (utils/opcache.py): the
    operator is loaded from there when this CSR and these options were
    built before, else built and saved. None takes MBT_LAYOUT_CACHE from
    the environment (as in the JAX package); '0' or 'off' (and no
    variable) builds without the cache.

    format:
      'auto'   — DIA if the top diagonals cover everything, hybrid if
                 they cover >= 50%; else windowed-ELL when n % 1024 == 0
                 and >= 95% of the nonzeros lie in their row tile's
                 1024-column window (and the build takes it); else the
                 butterfly layout, and gather-ELL where the butterfly
                 build refuses the matrix (a row wider than 24, a dense
                 block): the JAX package's layout rule
      'dia' / 'hybrid' — DIA, plus an ELL remainder if any
      'window' — windowed-ELL (ops/window_ell.py; n % 1024 == 0)
      'butterfly' — the butterfly-routed layout (ops/butterfly.py)
      'ell'    — gather-ELL (the layout closest to the reference's CSR)
    """
    if format not in ("auto", "dia", "ell", "hybrid", "window",
                      "butterfly"):
        raise ValueError(f"unknown format {format!r}")
    if cache_dir is None:
        cache_dir = os.environ.get("MBT_LAYOUT_CACHE") or "off"
    if cache_dir.lower() not in ("0", "off"):
        from mpi_bicgstab_tpu_torch.utils import opcache
        tag = "df32" if is_df32(dtype) else str(host_dtype(dtype,
                                                           csr.val.dtype))
        # the router enters the key: a NumPy-routed butterfly layout
        # has another tail than a native one (ops/native_route.py)
        key = opcache.operator_key(csr, format=format, dtype=tag,
                                   max_diags=max_diags,
                                   dia_min_fill=dia_min_fill,
                                   ell_width=ell_width,
                                   router=native_route.router())
        op = opcache.load_operator(cache_dir, key, resolve_device(device))
        if op is None:
            op = build_operator(csr, format=format, dtype=dtype,
                                max_diags=max_diags,
                                dia_min_fill=dia_min_fill,
                                ell_width=ell_width, device=device,
                                cache_dir="off")
            opcache.save_operator(cache_dir, key, op)
        return op
    route, offsets = (auto_route(csr, max_diags, dia_min_fill)
                      if format == "auto" else (format, None))
    while route in FALL_THROUGH:
        try:
            return _BUILDERS[route](csr, dtype=dtype, device=device)
        except LayoutRefused:
            if format != "auto":
                raise
            route = FALL_THROUGH[route]
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
    their row tile's window; else 'butterfly'. A build that refuses the
    matrix falls through (FALL_THROUGH, in build_operator)."""
    offsets, coverage = analyze_diagonals(csr, max_diags=max_diags,
                                          min_fill=dia_min_fill)
    if offsets and coverage >= 0.5:
        return "hybrid", offsets
    if (csr.nrows % 1024 == 0
            and window_ell_stats(csr)["window_frac"] >= 0.95):
        return "window", offsets
    return "butterfly", offsets


def spmv(op, x):
    """Generic y = op @ x over any ported layout (DF values take the DF
    SpMVs, as in the JAX package)."""
    with span("mbt.spmv"):
        if isinstance(op, ChebyOperator):
            return precond_spmv(op, x)       # y = A p(A) x (ops/cheby.py)
        if isinstance(op, DiaMatrix):
            return dia_spmv(op, x)
        if isinstance(op, EllMatrix):
            return ell_spmv_df(op, x) if is_df(op.vals) else ell_spmv(op, x)
        if isinstance(op, WindowEllMatrix):
            return (window_spmv_df(op, x) if is_df(op.vals)
                    else window_spmv(op, x))
        if isinstance(op, ButterflyMatrix):
            if is_df(op.k3_vals):
                y = butterfly_spmv_df(op, x)
                return DF(y.hi[: op.n_rows], y.lo[: op.n_rows])
            return butterfly_spmv(op, x)[: op.n_rows]
        if isinstance(op, HybridMatrix):
            if is_df(op.dia.vals):
                return df_add(dia_spmv(op.dia, x), ell_spmv_df(op.ell, x))
            return dia_spmv(op.dia, x) + ell_spmv(op.ell, x)
        raise TypeError(f"not a device sparse operator: {type(op)}")
