"""Seed-switching shifted solver with BLOCKED (deferred) shift updates
(counterpart of mpi_bicgstab_tpu/solvers/switching_blocked.py).

The flagship's cost is the shift-update pass: per iteration the whole
[S, n] state is read and written (shifted_switching_solver.c:429-445).
Each iteration's update is AFFINE in the iteration vectors with per-shift
scalar coefficients,

    x_k = x_{k-1} + cxp.p_{k-1} + cxq.q_k
    p_k = m1.(p_{k-1} + cpq.q_k + cpr.r_{k-1}) + m2.r_k

so L such steps compose into

    p_L = aP (.) p_0 + pr0 (.) r_0 + CpQ @ Q + CpR @ R
    x_L = x_0 + xA (.) p_0 + xr0 (.) r_0 + CxQ @ Q + CxR @ R

with [S] scalars (aP..xr0), [S, L] coefficient matrices composed by
O(S L) recurrences per iteration, and the Krylov basis Q = [q_1..q_L],
R = [r_1..r_L] recorded as [L, n] buffers. The [S, n] state is touched
once per L iterations, and the rank-L application is two [S, L] @ [L, n]
products per array: torch.matmul in full float32 (the JAX package's
lax.dot at Precision.HIGHEST; a plain library product outside any kernel).
TF32 would keep ~3 decimal digits, so the module refuses to run while
torch.backends.cuda.matmul.allow_tf32 is on; it never flips that setting.

Semantics: the per-iteration path's update ORDER (same scalar
recurrences, archives, per-shift stopping, worst-shift tracking and
history-rebase switching; a pending switch flushes the block first, as
the reference switches after iteration k's shift updates, ssw:490-527).
The products re-associate the sums, so trajectories match the
per-iteration build only to rounding. Stopped and seed rows compose with
cxp = cxq = cpq = cpr = 0, m1 = 1, m2 = 0, an exact identity.

Scope: float32 / float64. df32 keeps the per-iteration path: a float32
product rounds every term at 2^-24 and would throw the low parts away.
"""
from __future__ import annotations

import torch

from mpi_bicgstab_tpu_torch.ops.precision import is_df
from mpi_bicgstab_tpu_torch.parallel.sigma import as_shift_comm
from mpi_bicgstab_tpu_torch.solvers.base import start
from mpi_bicgstab_tpu_torch.solvers.shifted import _as_sigma
from mpi_bicgstab_tpu_torch.solvers.switching import (print_seed_relres,
                                                      seed_step, stop_test,
                                                      switch_seed,
                                                      worst_remaining)
from mpi_bicgstab_tpu_torch.utils.config import ShiftedConfig


def resolve_block(cfg, b, sigma_len: int) -> int:
    """Blocked-update depth L (0 = the per-iteration path).

    cfg.shift_block: -1 auto (64 for a float32 ladder of >= 8 shifts on
    the card, the JAX package's choice on the TPU; 0 on the CPU, as the
    JAX package picks 0 off the TPU), 0 off, > 0 an explicit L (at most
    max_iter). An explicit L on df32 raises."""
    sb = getattr(cfg, "shift_block", 0)
    if sb == 0:
        return 0
    if is_df(b):
        if sb > 0:
            raise ValueError(
                "shift_block is not supported for df32: the matrix-product "
                "application rounds at float32 and would discard the "
                "double-float accuracy (df32 takes the fused update)")
        return 0
    if sb > 0:
        return min(sb, cfg.max_iter)
    if b.device.type == "cuda" and b.dtype == torch.float32 \
            and sigma_len >= 8:
        return min(64, cfg.max_iter)
    return 0


def _check_no_tf32():
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "blocked shift updates need full-float32 matrix products, but "
            "torch.backends.cuda.matmul.allow_tf32 is on (TF32 keeps ~3 "
            "decimal digits); turn it off or pass shift_block=0")


def blocked_switching_loop(spmv, comm, b, sigma, cfg: ShiftedConfig,
                           carry, L: int, shift_comm=None):
    """Run the seed-switching solve from `carry` (the 16-slot tuple of
    switching.init_switching_carry) to the end with block depth L.
    Returns the final carry (the contract of switching._switching_loop
    with k_stop = max_iter + 1). The carry's state is updated in place.
    shift_comm (a parallel.sigma.SigmaComm): the slabs are this sigma
    group's rows, flushed with its rows of the [S] and [S, L]
    coefficients."""
    _check_no_tf32()
    sigma = _as_sigma(sigma, b)
    sc = as_shift_comm(shift_comm)
    dtype, dev = b.dtype, b.device
    S, n = sigma.shape[0], b.shape[0]
    tol2, exact, _ = start(b, cfg)
    M = cfg.max_iter
    idxL = torch.arange(L, device=dev)
    dot_zero = comm.dot(b, b)                    # :344-345
    (k, seed, x_set, p_set, r, eta, zeta, zp_eff, pi_arc, a_arc, b_arc,
     w_arc, stop, rTr, dot_r, hist) = carry
    k, seed = int(k), int(seed)
    done = (not exact) and bool(stop.all())      # :374; tol == 0 reads nothing
    while not done and k < M + 1:
        r0_blk = r
        Q = torch.zeros((L, n), dtype=dtype, device=dev)
        R = torch.zeros((L, n), dtype=dtype, device=dev)
        aP = torch.ones(S, dtype=dtype, device=dev)
        pr0, xA, xr0 = (torch.zeros(S, dtype=dtype, device=dev)
                        for _ in range(3))
        CpQ, CpR, CxQ, CxR = (torch.zeros((S, L), dtype=dtype, device=dev)
                              for _ in range(4))
        j, pend, ms_sw = 0, False, 0
        while j < L and not pend and not done and k < M + 1:
            # the seed iteration and the update coefficients, as the
            # per-iteration loop takes them; composed here, not applied
            (q, r_new, dot_r, rTr_new, (cxp, cxq, cpq, cpr, m1, m2), eta,
             zeta, zp_eff, abs_zp, not_seed) = seed_step(
                spmv, comm, b, sigma, seed, k, x_set, p_set, r, rTr, eta,
                zeta, zp_eff, pi_arc, a_arc, b_arc, w_arc, stop, sc)
            oh_j = (idxL == j).to(dtype)[None, :]               # [1, L]
            oh_jm1 = (idxL == j - 1).to(dtype)[None, :]
            # x_k = x + cxp.p_pre + cxq.q_j  (p_pre: before stages 1 and 2)
            xA = xA + cxp * aP
            xr0 = xr0 + cxp * pr0
            CxQ = CxQ + cxp[:, None] * CpQ + cxq[:, None] * oh_j
            CxR = CxR + cxp[:, None] * CpR
            # p stage 1 (:439-440): p += cpq.q_j + cpr.r_{k-1}
            CpQ = CpQ + cpq[:, None] * oh_j
            pr0 = pr0 + (cpr if j == 0 else torch.zeros_like(cpr))
            CpR = CpR + (cpr if j > 0 else torch.zeros_like(cpr))[:, None] \
                * oh_jm1
            # p stage 2 (:443-444): p = m1.p + m2.r_k
            aP = aP * m1
            pr0 = pr0 * m1
            CpQ = CpQ * m1[:, None]
            CpR = CpR * m1[:, None]
            CpR = CpR + m2[:, None] * oh_j
            # --- the basis rows ---
            Q[j] = q
            R[j] = r_new
            if not exact:   # tol == 0: no per-shift stop, no seed switch
                stop, done, pend = stop_test(stop, abs_zp, dot_r, tol2,
                                             dot_zero, seed)
                if pend:    # switch after the flush (:490)
                    ms_sw = worst_remaining(stop, not_seed, abs_zp)
            hist[k - 1] = dot_r
            print_seed_relres(cfg, k, dot_r, dot_zero)
            r, rTr = r_new, rTr_new
            j += 1
            k += 1
        # --- FLUSH: the rank-L application, in place (x first: it reads
        # the block-entry p, whose non-seed rows are untouched until the
        # p flush; the seed row's coefficients are 0). The sums associate
        # as the JAX expression's, left to right. ---
        x_set += sc.loc(xA)[:, None] * p_set
        x_set += sc.loc(xr0)[:, None] * r0_blk[None, :]
        x_set += torch.matmul(sc.loc(CxQ), Q)
        x_set += torch.matmul(sc.loc(CxR), R)
        p_set.mul_(sc.loc(aP)[:, None])
        p_set += sc.loc(pr0)[:, None] * r0_blk[None, :]
        p_set += torch.matmul(sc.loc(CpQ), Q)
        p_set += torch.matmul(sc.loc(CpR), R)
        # --- seed switching (:490-527) after the flush, at k_sw = k - 1,
        # the iteration that found it ---
        if pend:
            (seed, r, eta, zeta, zp_eff, pi_arc, a_arc, b_arc,
             w_arc) = switch_seed(cfg, sigma, seed, ms_sw, k - 1, r, eta,
                                  zeta, zp_eff, pi_arc, a_arc, b_arc, w_arc,
                                  stop)
    return (k, seed, x_set, p_set, r, eta, zeta, zp_eff, pi_arc, a_arc,
            b_arc, w_arc, stop, rTr, dot_r, hist)
