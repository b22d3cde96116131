"""Result container and the exact-iterations contract (counterpart of
mpi_bicgstab_tpu/solvers/base.py)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Result of a classic-family solve.

    x:            solution vector, on the device of the solve
    n_iter:       iterations executed (reference return value, solver.c:145)
    final_relres: 0-d tensor, sqrt(dot_r / dot_zero) — the recursive
                  residual the reference prints as "Final r" (solver.c:136)
    history:      [max_iter] per-iteration relative residuals, NaN beyond
                  n_iter
    converged:    0-d bool tensor: the recursive test
                  dot_r <= tol^2 * dot_zero at exit AND
                  true_relres <= 100 * tol. The recurrences can decouple
                  from the true residual, so one extra SpMV at exit gates
                  convergence on the truth.
    true_relres:  0-d tensor, ||b - A x|| / ||r0|| computed at exit
    """

    x: torch.Tensor
    n_iter: int
    final_relres: torch.Tensor
    history: torch.Tensor
    converged: torch.Tensor
    true_relres: torch.Tensor


def exact_iters(cfg) -> bool:
    """True when cfg.tol == 0.0 — the benchmark contract: run EXACTLY
    max_iter iterations with no residual-based exit.

    With tol = 0 the loop condition `dot_r > tol^2 * dot_zero` reads
    `dot_r > 0`. Once an easy system converges past the float32 floor the
    recurrences break down and dot_r becomes NaN or exactly 0, and
    `NaN > 0` is False — the loop would exit early at a data-dependent
    iteration and silently truncate tol=0 slope timings. So tol == 0
    drops the residual test altogether (and with it the per-iteration
    host synchronisation)."""
    return float(getattr(cfg, "tol", 1.0)) == 0.0
