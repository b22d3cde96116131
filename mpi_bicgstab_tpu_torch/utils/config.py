"""Solver configuration (counterpart of mpi_bicgstab_tpu/utils/config.py).

The reference's compile-time EPS / MAX_ITER / OUT_ITER constants
(solver.c:3-9) as a runtime dataclass whose defaults mirror them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def canon_dtype(dt) -> torch.dtype:
    """torch.float32 / torch.float64 from a torch dtype, a numpy dtype or
    its name. "df32" (double-float pairs, ops/precision.py) computes in
    float32 storage, so its config dtype is torch.float32, as in the JAX
    package: the dtype the fused DF route dispatches on."""
    if isinstance(dt, torch.dtype):
        if dt in (torch.float32, torch.float64):
            return dt
        raise ValueError(f"unsupported dtype {dt}; use float32 or float64")
    if isinstance(dt, str):
        name = dt
    else:
        try:
            name = np.dtype(dt).name
        except TypeError as e:
            raise ValueError(f"unsupported dtype {dt!r}") from e
    if name == "df32":
        return torch.float32
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {dt!r}; use float32 or float64")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Configuration for the classic BiCGStab family.

    tol:      relative-residual stopping tolerance; the loop stops when
              (r,r) <= tol^2 * (r0,r0) (reference solver.c:86). tol == 0
              runs exactly max_iter iterations (solvers.base.exact_iters).
    max_iter: iteration cap (solver.c:4).
    krr, nrr: residual-replacement period and count of pipe_bicgstab_rr
              (solver.c:433, main.c:134-135): every krr iterations, at
              most nrr times, the recurrences are re-anchored.
    restarts: refinement restarts when the recurrence hit tol but the
              true residual did not (api._restarted); 0 is the
              reference's one-pass behaviour.
    dtype:    torch.float32 or torch.float64 (names and numpy dtypes are
              accepted and canonicalised; "df32" becomes torch.float32).
    out_iter: print the relative residual every out_iter iterations
              (DISPLAY_RESIDUAL, solver.c:8-9,122-126); 0 is silent and
              is required for the fused float32 route.
    serialize_comm: the reference's *_nooverlap mode for distributed
              runs: every collective completes before the compute that
              would hide it (parallel/comm.Comm(serialize=True)); the
              solve takes the unfused solvers, as in the JAX package.
              Same bits as the overlapped run.
    """

    tol: float = 1.0e-15
    max_iter: int = 1000
    krr: int = 100
    nrr: int = 4
    restarts: int = 2
    dtype: torch.dtype = torch.float64
    out_iter: int = 0
    serialize_comm: bool = False

    def __post_init__(self):
        object.__setattr__(self, "dtype", canon_dtype(self.dtype))

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShiftedConfig:
    """Configuration for the shifted (multi-sigma) solver family.

    Reference defaults: EPS 1e-12 (shifted_solver.c:5,
    shifted_switching_solver.c:5), MAX_ITER 1000; the sigma ladder and
    the seed index are runtime inputs of the drivers (main_shifted.c:95-100).

    tol, max_iter, dtype, out_iter: as in SolverConfig (tol == 0 runs
              exactly max_iter iterations: no shift stops, no seed switch).
    verbose_switch: print seed-switch events (the reference prints them
              unconditionally, shifted_switching_solver.c:519-526).
    shift_block: blocked (deferred, matrix-product) shift updates of the
              seed-switching solver (solvers/switching_blocked.py): -1
              auto (L = 64 for a float32 ladder of >= 8 shifts on the
              card; the Q/R recording buffers take 2 L n 4 bytes, ~820 MB
              at 1.6M rows), 0 the per-iteration path, > 0 an explicit
              depth L. The checkpointed segment driver always takes the
              per-iteration path (bit-exact resume).
    serialize_comm: the no-overlap mode, as in SolverConfig.
    """

    tol: float = 1.0e-12
    max_iter: int = 1000
    dtype: torch.dtype = torch.float64
    out_iter: int = 0
    verbose_switch: bool = False
    shift_block: int = -1
    serialize_comm: bool = False

    def __post_init__(self):
        object.__setattr__(self, "dtype", canon_dtype(self.dtype))

    def replace(self, **kw) -> "ShiftedConfig":
        return dataclasses.replace(self, **kw)
