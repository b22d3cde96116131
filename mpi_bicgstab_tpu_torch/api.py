"""High-level single-device solve API (counterpart of
mpi_bicgstab_tpu/api.py: `solve`, `_restarted` and the dispatch of
`_solve_jit`; the batched `solve_batched`, `_restart_batch_lanes` and the
dispatch of `_solve_batched_jit`; the shifted family's `solve_shifted`,
`solve_shifted_checkpointed` and `refine_shifted_solutions`).

The solve runs where A and b live: on the card for an operator built
with device='cuda' (the default of models.problem.build_problem), on the
CPU only when the caller built it there. A double-float problem
(build_problem(dtype="df32")) carries DF pairs (ops/precision.DF) in A,
b and x0.

Batched solves (solve_batched, B [k, n]) route as the JAX package routes
them on its TPU: float32 bicgstab on a square DiaMatrix with 1 <= k <= 8
lanes takes the fused batched driver (three passes per iteration over all
lanes, the band read once per pass; on the card kernels 19-22 of
csrc/batched_spmv.cu and csrc/fused_batched.cu). Everything else (float64,
df32, the other methods, other layouts, k > 8) solves lane by lane with
the unfused solver over the generic SpMV: what jax.vmap computes, each
lane as if solved alone (on the card through the DIA or ELL SpMV
kernels).

Chebyshev preconditioning (precond=ops.cheby.ChebyPrecond, or A already
an ops.cheby.ChebyOperator) wraps A, and the solve runs right-
preconditioned, as in the JAX package (api.py:281-289,398-440): the
solver iterates on A p(A) in y, restarts re-enter it in y, and x = p(A) y
is applied once per solve and once per lane at exit. A ChebyOperator is
not a DiaMatrix, so every fused route refuses it and the unfused solver
runs over layout.spmv, whose p(A) is the chain kernel on a float32 or DF
DIA operator (ops/cuda_cheby.py).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mpi_bicgstab_tpu_torch.ops import cuda_batched_spmv as cbs
from mpi_bicgstab_tpu_torch.ops import cuda_fused_ca as fca
from mpi_bicgstab_tpu_torch.ops import cuda_fused_ca_df as fcadf
from mpi_bicgstab_tpu_torch.ops import cuda_fused_classic as fcl
from mpi_bicgstab_tpu_torch.ops import cuda_fused_classic_df as fcldf
from mpi_bicgstab_tpu_torch.ops import cuda_fused_pipe as fpipe
from mpi_bicgstab_tpu_torch.ops import cuda_fused_pipe_df as fpipedf
from mpi_bicgstab_tpu_torch.ops.cheby import ChebyOperator, wrap_operator
from mpi_bicgstab_tpu_torch.ops.layout import spmv as generic_spmv
from mpi_bicgstab_tpu_torch.ops.precision import DF, is_df, vzeros_like
from mpi_bicgstab_tpu_torch.parallel.comm import Comm
from mpi_bicgstab_tpu_torch.solvers.base import SolveResult, exact_iters
from mpi_bicgstab_tpu_torch.solvers.bicgstab import CLASSIC_SOLVERS
from mpi_bicgstab_tpu_torch.utils.config import SolverConfig

METHODS = tuple(CLASSIC_SOLVERS)
# float32 DIA drivers over the fused kernels; BiCGStab(l) has none
FUSED = {"bicgstab": fcl.bicgstab_fused,
         "ca_bicgstab": fca.ca_bicgstab_fused,
         "pipe_bicgstab": fpipe.pipe_bicgstab_fused,
         "pipe_bicgstab_rr": fpipe.pipe_bicgstab_rr_fused}
# df32 DIA drivers over the fused DF kernels
FUSED_DF = {"bicgstab": fcldf.bicgstab_fused_df,
            "ca_bicgstab": fcadf.ca_bicgstab_fused_df,
            "pipe_bicgstab": fpipedf.pipe_bicgstab_fused_df,
            "pipe_bicgstab_rr": fpipedf.pipe_bicgstab_rr_fused_df}


def _solve_once(A, b, x0, method: str, cfg: SolverConfig) -> SolveResult:
    """One solver pass, routed as the JAX `_solve_jit` routes it: on a
    square DiaMatrix, float32 takes the method's fused driver (FUSED)
    and df32 (DF values) its fused DF driver (FUSED_DF) for classic, CA,
    pipelined and pipelined-RR BiCGStab; everything else, and
    BiCGStab(l) always, the unfused solver over the generic SpMV. The
    route is the same on the CPU and on the card; only each kernel
    wrapper's choice between kernel and plain twin follows the tensors'
    device. cfg.out_iter != 0 takes the unfused route, where the
    periodic residual print lives. A ChebyOperator takes the unfused
    route; there df32 pipelined BiCGStab runs its fused DF iteration
    bodies (solvers/bicgstab.pipe_bicgstab), as on any other layout and
    with out_iter."""
    if is_df(b) and method in FUSED_DF and not cfg.out_iter \
            and fcldf.format_ok(A, cfg.dtype):
        return FUSED_DF[method](A, b, x0, cfg)
    if method in FUSED and not cfg.out_iter \
            and fcl.format_ok(A, cfg.dtype):
        return FUSED[method](A, b, x0, cfg)
    return CLASSIC_SOLVERS[method](lambda v: generic_spmv(A, v), Comm(), b,
                                   x0, cfg)


def _restart_tol(outer_tol: float, scale: float) -> float:
    """Inner tolerance for a refinement restart whose r0 is `scale` times
    the original r0: the correction solve must reduce its own relative
    residual by ~outer_tol/scale for the OUTER true residual to reach
    outer_tol. Quantised down to a decade, as in the JAX package, so that
    both packages run the same segments."""
    t = 0.1 * outer_tol / max(scale, 1e-300)
    t = 10.0 ** math.floor(math.log10(max(t, 1e-300)))
    return float(min(max(t, outer_tol), 1e-1))


def _restarted(solve_fn, cfg, res: SolveResult) -> SolveResult:
    """Re-enter the solver from the current iterate while the recurrence
    says "done" but the true residual has not reached the gate (the
    reference trusts the recurrence and prints success). solve_fn(x0,
    cfg) runs one segment; relres and history stay relative to the
    ORIGINAL r0."""
    if exact_iters(cfg):
        return res    # tol=0 contract: no restart segments either
    scale = 1.0                       # segment r0 norm in outer units
    total_iter = res.n_iter
    hist = [res.history[:total_iter].cpu().numpy()]
    for _ in range(max(int(cfg.restarts), 0)):
        if bool(res.converged):
            break
        est = float(res.final_relres)
        t_out = float(res.true_relres) * scale
        seg_tol = _restart_tol(cfg.tol, scale) if scale != 1.0 else cfg.tol
        est_hit = est <= seg_tol * (1.0 + 1e-3)
        if not (est_hit and np.isfinite(t_out) and t_out > 100.0 * cfg.tol):
            break       # stalled loop / breakdown: a restart cannot fix
            # what the recurrence never claimed to finish
        if t_out >= 0.5 * scale and scale != 1.0:
            break       # no progress in the last segment: futile
        new_scale = t_out
        res = solve_fn(res.x, cfg.replace(tol=_restart_tol(cfg.tol,
                                                           new_scale)))
        scale = new_scale
        total_iter += res.n_iter
        hist.append(res.history[:res.n_iter].cpu().numpy() * scale)
    if scale == 1.0:
        return res      # no restart fired: untouched
    t_out = float(res.true_relres) * scale
    est = float(res.final_relres)
    converged = (est <= _restart_tol(cfg.tol, scale) * (1.0 + 1e-3)
                 and t_out <= 100.0 * cfg.tol)
    h = np.concatenate(hist)[: cfg.max_iter]
    h = np.pad(h, (0, cfg.max_iter - h.shape[0]), constant_values=np.nan)
    dev, dt = res.x.device, res.final_relres.dtype
    return SolveResult(
        x=res.x, n_iter=min(total_iter, 2**31 - 1),
        final_relres=torch.tensor(est * scale, dtype=dt, device=dev),
        history=torch.tensor(h, dtype=res.history.dtype, device=dev),
        converged=torch.tensor(converged, device=dev),
        true_relres=torch.tensor(t_out, dtype=dt, device=dev))


def solve(A, b, x0=None, method: str = "bicgstab",
          cfg: SolverConfig | None = None, precond=None) -> SolveResult:
    """Solve A x = b with a method of the classic family (METHODS) where
    A and b live. When the true-residual gate fails after the recurrence
    hit tol, up to cfg.restarts refinement restarts re-enter the solver
    from the current iterate.

    precond: an ops.cheby.ChebyPrecond with its bounds set, or pass A
    already wrapped in a ChebyOperator. The solve then runs right-
    preconditioned (module doc): every residual is the original
    system's, x0 (if given) is in the preconditioned space, and x = p(A) y
    is applied once at exit."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; choose from "
                         f"{sorted(METHODS)}")
    A = _wrap(A, precond)
    b = _check_rhs(A, b, "solve")
    if cfg is None:
        cfg = SolverConfig(dtype=b.dtype)
    if x0 is None:
        x0 = vzeros_like(b)
    res = _solve_once(A, b, x0, method, cfg)
    if cfg.restarts:
        res = _restarted(lambda x, c: _solve_once(A, b, x, method, c),
                         cfg, res)
    if isinstance(A, ChebyOperator):
        res = dataclasses.replace(res, x=A.apply(res.x))
    return res


def _wrap(A, precond):
    """A wrapped in the Chebyshev operator of `precond` (its bounds set;
    ChebyPrecond.resolve estimates them from a host CSR)."""
    if precond is not None and not isinstance(A, ChebyOperator):
        A = wrap_operator(A, precond)
    return A


def _check_rhs(A, b, what: str):
    if not (torch.is_tensor(b) or is_df(b)):
        b = torch.as_tensor(np.asarray(b), device=A.device)
    if b.device != A.device:
        raise ValueError(f"b is on {b.device} but A is on {A.device}; "
                         f"{what} runs where both live")
    return b


# --- batched right-hand sides (api.py:292-401 of the JAX package) ------------

def _stack_x(xs: list):
    """[k, n] from k lane vectors (tensors or DF pairs)."""
    if is_df(xs[0]):
        return DF(torch.stack([v.hi for v in xs]),
                  torch.stack([v.lo for v in xs]))
    return torch.stack(xs)


def _stack_lanes(lanes: list) -> SolveResult:
    """One SolveResult with a leading batch axis from per-lane ones."""
    return SolveResult(
        x=_stack_x([r.x for r in lanes]),
        n_iter=torch.tensor([r.n_iter for r in lanes], dtype=torch.int32),
        **{f: torch.stack([getattr(r, f) for r in lanes])
           for f in ("final_relres", "history", "converged", "true_relres")})


def _solve_batched_once(A, B, X0, method: str, cfg) -> SolveResult:
    """One batched pass, routed as the JAX `_solve_batched_jit` routes it
    on its TPU (module doc). The route is the same on the CPU and on the
    card; only each kernel wrapper's choice between kernel and plain twin
    follows the tensors' device. The JAX package falls back from its
    fused batched passes to the SpMV-amortised loop when their VMEM
    windows do not fit; on the card both take the same operators, so the
    fused driver always runs and no route reaches the loop. A
    ChebyOperator solves lane by lane."""
    from mpi_bicgstab_tpu_torch.solvers.batched_fused import \
        bicgstab_batched_fully_fused
    k = B.shape[0]
    if method == "bicgstab" and not is_df(B) \
            and cbs.format_ok(A, cfg.dtype, k):
        return bicgstab_batched_fully_fused(A, B, X0, cfg)
    fn = CLASSIC_SOLVERS[method]
    return _stack_lanes([fn(lambda v: generic_spmv(A, v), Comm(), B[j],
                            X0[j], cfg) for j in range(k)])


def _restart_batch_lanes(A, B, method: str, cfg, res: SolveResult):
    """Per-lane refinement restarts after a batched solve: a lane whose
    recurrence hit tol but failed the true-residual gate re-enters the
    single-RHS solver (_solve_once) on its own, by the policy of
    _restarted."""
    if exact_iters(cfg):
        return res    # tol=0 contract: no restart segments (and no read)
    conv = res.converged.cpu().numpy()
    if conv.all():
        return res
    x = DF(res.x.hi.clone(), res.x.lo.clone()) if is_df(res.x) \
        else res.x.clone()
    fields = {f: getattr(res, f).clone() for f in (
        "n_iter", "final_relres", "history", "converged", "true_relres")}
    for j in np.flatnonzero(~conv):
        lane = SolveResult(x=x[j], **{f: (int(v[j]) if f == "n_iter"
                                          else v[j])
                                      for f, v in fields.items()})
        lane2 = _restarted(
            lambda x0, c, j=j: _solve_once(A, B[j], x0, method, c), cfg,
            lane)
        if lane2 is lane:
            continue                # no restart fired for this lane
        if is_df(x):
            x.hi[j], x.lo[j] = lane2.x.hi, lane2.x.lo
        else:
            x[j] = lane2.x
        for f, v in fields.items():
            v[j] = getattr(lane2, f)
    return SolveResult(x=x, **fields)


def solve_batched(A, B, x0=None, method: str = "bicgstab",
                  cfg: SolverConfig | None = None,
                  precond=None) -> SolveResult:
    """Solve A x_j = b_j for a BATCH of right-hand sides at once (beyond
    the reference, which is strictly one RHS per run), where A and B
    live. B is [k, n] (a DF pair of [k, n] for df32); the result's fields
    carry a leading batch axis (n_iter a [k] int32 tensor on the host).
    The loop runs until the LAST lane stops; stopped lanes freeze, so
    each lane's n_iter, history, converged and true_relres are those it
    would have alone. Lanes whose recurrence hit tol but failed the
    true-residual gate re-enter the single-RHS solver one by one
    afterwards (cfg.restarts, the policy of `solve`). precond as for
    `solve`: each lane's x = p(A) y_j at exit."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; choose from "
                         f"{sorted(METHODS)}")
    A = _wrap(A, precond)
    B = _check_rhs(A, B, "solve_batched")
    if len(B.shape) != 2:
        raise ValueError(f"B must be [k, n], got shape {tuple(B.shape)}")
    if cfg is None:
        cfg = SolverConfig(dtype=B.dtype)
    if x0 is None:
        x0 = vzeros_like(B)
    res = _solve_batched_once(A, B, x0, method, cfg)
    if cfg.restarts:
        res = _restart_batch_lanes(A, B, method, cfg, res)
    if isinstance(A, ChebyOperator):
        res = dataclasses.replace(res, x=_stack_x(
            [A.apply(res.x[j]) for j in range(res.x.shape[0])]))
    return res


# --- the shifted family (api.py:81-204 of the JAX package) -------------------

def _all_shifted_solvers():
    from mpi_bicgstab_tpu_torch.solvers.shifted import SHIFTED_SOLVERS
    from mpi_bicgstab_tpu_torch.solvers.switching import SWITCHING_SOLVERS
    return {**SHIFTED_SOLVERS, **SWITCHING_SOLVERS}


def _ladder(b, sigma):
    """The shift ladder beside b: for a DF b split host-side from float64
    into pairs, so that sigma keeps its float64 precision; otherwise a
    tensor of b's dtype. A ladder already of that kind on b's device
    passes as it is (a captured CUDA graph cannot copy from the host)."""
    from mpi_bicgstab_tpu_torch.ops.precision import df_from_f64
    if is_df(b):
        if is_df(sigma):
            return sigma.to(b.device)
        if torch.is_tensor(sigma):
            sigma = sigma.cpu().numpy()
        return df_from_f64(np.asarray(sigma, np.float64), b.device)
    if torch.is_tensor(sigma) and sigma.dtype == b.dtype \
            and sigma.device == b.device:
        return sigma
    return torch.as_tensor(np.asarray(sigma), dtype=b.dtype, device=b.device)


def _shifted_inputs(A, b, sigma, seed: int):
    b = _check_rhs(A, b, "solve_shifted")
    sigma = _ladder(b, sigma)
    if not (0 <= seed < sigma.shape[0]):
        raise ValueError(f"seed {seed} out of range for {sigma.shape[0]} "
                         f"shifts")
    return b, sigma


def solve_shifted(A, b, sigma, seed: int = 0,
                  method: str = "shifted_lopbicgstab", cfg=None):
    """Solve (A + sigma_j I) x_j = b for every shift of the ladder from one
    Krylov sequence (x0 = 0, as in every reference driver), where A and b
    live. For method='shifted_bicgstab' the seed is the unshifted system
    and the seed argument is ignored (reference shifted_solver.c:90)."""
    from mpi_bicgstab_tpu_torch.utils.config import ShiftedConfig
    solvers = _all_shifted_solvers()
    if method not in solvers:
        raise ValueError(f"unknown method {method!r}; "
                         f"choose from {sorted(solvers)}")
    b, sigma = _shifted_inputs(A, b, sigma, seed)
    if cfg is None:
        cfg = ShiftedConfig(dtype=b.dtype)
    spmv = lambda v: generic_spmv(A, v)  # noqa: E731
    fn = solvers[method]
    if method == "shifted_bicgstab":
        return fn(spmv, Comm(), b, sigma, cfg)
    return fn(spmv, Comm(), b, sigma, int(seed), cfg)


def solve_shifted_checkpointed(A, b, sigma, seed: int, cfg, path: str,
                               segment_iters: int, meta: dict):
    """Seed-switching shifted solve with FULL-CARRY checkpointing: the
    solver's whole loop state is saved to `path` every `segment_iters`
    iterations and resumed from it when present. The segmented run is
    BIT-IDENTICAL to an uninterrupted solve_shifted(...,
    method='shifted_lopbicg_switching') on the per-iteration path.

    Returns (ShiftedResult, total_iters)."""
    from mpi_bicgstab_tpu_torch.solvers.switching import (
        init_switching_carry, shifted_lopbicg_switching_segment)
    from mpi_bicgstab_tpu_torch.utils.checkpoint import \
        solve_switching_with_checkpoints
    b, sigma = _shifted_inputs(A, b, sigma, seed)
    init_carry = init_switching_carry(b, sigma, int(seed), cfg, comm=Comm())
    spmv = lambda v: generic_spmv(A, v)  # noqa: E731
    runner = lambda carry, k_stop: shifted_lopbicg_switching_segment(  # noqa
        spmv, Comm(), b, sigma, cfg, carry, k_stop)
    return solve_switching_with_checkpoints(
        runner, init_carry, path, segment_iters, cfg.max_iter, meta)


def refine_shifted_solutions(A, b, sigma, x_set, cfg=None, chunk: int = 128):
    """Polish per-shift solutions with a batched BiCGStab over the shift
    axis until every TRUE residual ||b - (A + sigma_j) x_j|| meets
    cfg.tol ||b|| (solvers/refine.py). Ladders wider than `chunk` refine in
    chunks (the batched state is ~5 [S, n] vectors). Returns (x_set,
    n_iter, true_relres [S])."""
    from mpi_bicgstab_tpu_torch.ops.precision import vcat, vvalue
    from mpi_bicgstab_tpu_torch.solvers.refine import refine_shifted
    b, sigma = _shifted_inputs(A, b, sigma, 0)
    if cfg is None:
        cfg = SolverConfig(tol=1e-10, max_iter=500, dtype=vvalue(b).dtype)
    spmv = lambda v: generic_spmv(A, v)  # noqa: E731
    S = sigma.shape[0]
    outs, iters, rels = [], 0, []
    for s0 in range(0, S, chunk):
        sl = slice(s0, min(s0 + chunk, S))
        x2, k, rr = refine_shifted(spmv, Comm(), b, sigma[sl], x_set[sl],
                                   cfg)
        outs.append(x2)
        iters = max(iters, k)
        rels.append(rr)
    if len(outs) == 1:
        return outs[0], iters, rels[0]
    return vcat(outs, 0), iters, torch.cat(rels)
