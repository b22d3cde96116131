"""Result container, the exact-iterations contract and the pieces every
classic-family solver shares (counterpart of
mpi_bicgstab_tpu/solvers/base.py, plus `_finish`, `_maybe_print_residual`
of mpi_bicgstab_tpu/solvers/bicgstab.py)."""
from __future__ import annotations

import dataclasses

import torch

from mpi_bicgstab_tpu_torch.ops.precision import vvalue, vzeros


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


def maybe_print_residual(cfg, k, dot_r, dot_zero):
    """DISPLAY_RESIDUAL (solver.c:8-9,122-126): print the relative
    residual every cfg.out_iter iterations (1-based labels)."""
    if cfg.out_iter and (k + 1) % cfg.out_iter == 0:
        print(f"iter {k + 1}: relres "
              f"{float(torch.sqrt(vvalue(dot_r) / vvalue(dot_zero))):.6e}")


def finish(x, k, dot_r, dot_zero, tol2, hist, max_iter, spmv, comm, b,
           step=1, f32_test=False):
    """SolveResult with the true-residual gate: one extra SpMV at exit,
    because the recursive residual the loop stopped on can decouple from
    the truth (SolveResult.converged). hist[i] is the (r,r) of history
    slot step * (i + 1) - 1 (step = l for BiCGStab(l)).

    With DF pairs (df32) relres, history and true_relres are float32,
    from vvalue (JAX solvers/bicgstab.py `_finish`), and the recursive
    test dot_r <= dot_zero tol^2 is taken DF-first; f32_test takes it on
    the float32 values instead, as the fused DF loop's stop test does
    (JAX pallas_fused_classic_df.bicgstab_fused_df)."""
    dz = vvalue(dot_zero)
    relres = torch.sqrt(vvalue(dot_r) / dz)
    history = torch.full((max_iter,), float("nan"), dtype=dz.dtype,
                         device=dz.device)
    if hist:
        history[step - 1::step][:len(hist)] = torch.sqrt(
            torch.stack([vvalue(h) for h in hist]) / dz)
    r_true = b - spmv(x)
    true_relres = torch.sqrt(vvalue(comm.dot(r_true, r_true)) / dz)
    tol = torch.sqrt(tol2)
    done = (vvalue(dot_r) <= dz * tol2) if f32_test \
        else (dot_r <= dot_zero * tol2)
    return SolveResult(x=x, n_iter=k, final_relres=relres, history=history,
                       converged=done & (true_relres <= 100.0 * tol),
                       true_relres=true_relres)


def start(b, cfg):
    """tol^2 as a 0-d tensor, the tol=0 flag and a 0-d zero of b's kind
    (a DF pair for a DF b), made on the device without a copy from the
    host (so that a tol=0 solve, which never synchronises, can be
    captured in a CUDA graph). For a DF b, tol^2 is float32, as in the
    JAX package."""
    tol2 = torch.full((), cfg.tol, dtype=b.dtype, device=b.device) ** 2
    return tol2, exact_iters(cfg), vzeros((), b)


def is_rr(k: int, cfg) -> bool:
    """Is iteration k (0-based) a residual-replacement iteration?
    (solver.c:498: every krr iterations, at most nrr times)"""
    return k > 0 and k <= cfg.krr * cfg.nrr and k % cfg.krr == 0


def fold_beta_alpha(alpha, omega, rTr, rTr_new, rhTw, rhTs, rhTz):
    """The end of a CA or pipelined iteration (reference solver.c:248-249
    and 387-388): (beta', alpha') from the iteration's scalars and its
    dots. On DF pairs the operators are ops/precision.py's, in the JAX
    expression's nesting, which the DF kernels' FoldBetaAlpha
    (csrc/df_core.cuh) follows."""
    beta = (alpha / omega) * (rTr_new / rTr)
    return beta, rTr_new / (rhTw + beta * (rhTs - omega * rhTz))
