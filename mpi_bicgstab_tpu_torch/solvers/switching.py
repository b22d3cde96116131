"""Shifted LOP-BiCG with per-shift stopping and seed switching — the
reference's flagship solver (what its root Makefile builds); counterpart
of mpi_bicgstab_tpu/solvers/switching.py.

  shifted_lopbicg           reference shifted_switching_solver.c:20-257.
      LOP-BiCG shifted solve where each converged shift freezes its vector
      updates (stop_flag, :75, :136-149): a boolean mask over the shift
      axis, folded into the update coefficients.

  shifted_lopbicg_switching reference shifted_switching_solver.c:260-608.
      Also archives the per-iteration seed scalars alpha/beta/omega and
      the pi history [iter, sigma] (:320-323). When the seed system
      converges while shifts remain, it picks the WORST remaining shift
      (max |1/(zeta pi)|, :470-473), REBASES the scalar history onto it as
      the new seed (alpha/beta/omega remap :494-498, residual rescale
      :499, pi/zeta recompute over all past iterations :509-517), sets
      seed = max_sigma (:525) and keeps iterating.

The loop runs on the host. The seed index and the iteration count are
Python ints; the stop flags are read once per iteration (the loop
condition and the switch test share the read), and a switch is a host
`if` whose history recompute is a Python loop over the past iterations.
With tol == 0 (the bench contract) nothing stops and nothing switches,
and the loop reads nothing from the device, so a tol=0 solve can be
captured in a CUDA graph.

The [S, n] x_set / p_set state is updated in place: the loop OWNS the
carry it is given. A double-float state takes the fused shift-update
kernel (ops/cuda_shift_update.fused_shift_update_df: the kernel on the
card, its plain twin on the CPU); any other state the masked update
expressions of the JAX package's XLA branch (switching.py:343-355),
in place. float32 ladders on the card take the blocked path of
solvers/switching_blocked.py instead (ShiftedConfig.shift_block).

Like the reference, rTr is NOT rescaled with r at a switch (:499 scales r
only).

Accuracy limit at long iteration counts (measured in the JAX package):
the per-shift solutions come from collinearity recurrences that are never
re-anchored to the true residuals, so their TRUE error drifts above the
estimated residual over thousands of iterations. Validate long ladders
with --check-error, or polish them with --refine (solvers/refine.py).
"""
from __future__ import annotations

import torch

from mpi_bicgstab_tpu_torch.ops.cuda_shift_update import fused_shift_update_df
from mpi_bicgstab_tpu_torch.ops.precision import (is_df, vabs,
                                                  vbroadcast_rows, vcat,
                                                  vfma, vones, vvalue,
                                                  vwhere, vzeros)
from mpi_bicgstab_tpu_torch.parallel.sigma import as_shift_comm
from mpi_bicgstab_tpu_torch.solvers.base import ShiftedResult, start
from mpi_bicgstab_tpu_torch.solvers.shifted import (_as_sigma, add_update,
                                                    hist_init, scale_add,
                                                    seed_true_relres,
                                                    set_at)
from mpi_bicgstab_tpu_torch.utils.config import ShiftedConfig
from mpi_bicgstab_tpu_torch.utils.timing import host_read, span


def shifted_lopbicg(spmv, comm, b, sigma, seed: int, cfg: ShiftedConfig,
                    shift_comm=None) -> ShiftedResult:
    """Per-shift-stopping LOP-BiCG (shifted_switching_solver.c:20-257).

    Converged shifts keep their x/p frozen through the active mask; the
    loop runs until every shift (the seed system included) meets
    |1/(zeta_j pi_j)|^2 (r,r) <= tol^2 (r0,r0)  (:199, seed scale 1 :192)."""
    sigma = _as_sigma(sigma, b)
    sc = as_shift_comm(shift_comm)
    S, n = sigma.shape[0], b.shape[0]
    tol2, exact, _ = start(b, cfg)
    not_seed = torch.arange(S, device=b.device) != seed
    sig_seed = sigma[seed]

    r_hat = b
    rTr = comm.dot(b, b)                        # :83-84
    dot_zero = dot_r = rTr
    x_set = vzeros((sc.s_local(S), n), b)
    p_set = vbroadcast_rows(b, sc.s_local(S))   # :87 p[j] = b
    alpha = vones((S,), b)
    beta = vzeros((S,), b)
    eta = vzeros((S,), b)
    zeta = vones((S,), b)
    pi_new = vones((S,), b)
    stop = torch.zeros(S, dtype=torch.bool, device=b.device)    # :75
    hist = hist_init(cfg, b)
    r, k = b, 0
    # :106; tol == 0 never stops a shift, so it reads nothing
    while k < cfg.max_iter and (exact or not bool(stop.all())):
        active = not_seed & ~stop               # :137-138
        r_old = r                               # :108
        pi_old = pi_new                         # :109
        alpha_old, beta_old = alpha[seed], beta[seed]   # :110-111
        p_seed = sc.take_row(p_set, seed)
        s = spmv(p_seed) + sig_seed * p_seed    # :113-114
        rTs = comm.dot(r_hat, s)                # :116
        a_s = rTr / rTs                         # :119
        q = vfma(r, -a_s, s)                    # :120
        y = spmv(q) + sig_seed * q              # :121-122
        qTq, qTy = comm.dots((q, q), (q, y))    # :123-124
        w_s = qTq / qTy                         # :128
        x_set = sc.row_add(x_set, seed,
                        vfma(a_s * p_seed, w_s, q))  # :129-130
        # shift update (:136-149), the active mask folded into the
        # coefficients (inactive rows: 0 increment / (1, 0) affine)
        eta2 = (beta_old / alpha_old) * a_s * eta \
            - (sig_seed - sigma) * a_s * pi_old
        pi_new2 = eta2 + pi_old
        alpha_sh = (pi_old / pi_new2) * a_s
        omega_sh = w_s / (1.0 - w_s * (sig_seed - sigma))
        x_set = add_update(x_set, sc.coeff(active, alpha_sh), p_set,
                           sc.coeff(active, omega_sh / (pi_new2 * zeta)),
                           q[None, :])
        p_set = add_update(
            p_set, sc.coeff(active, omega_sh / (alpha_sh * zeta * pi_new2)),
            q[None, :],
            sc.coeff(active, -(omega_sh / (alpha_sh * zeta * pi_old))),
            r_old[None, :])
        zeta2 = (1.0 - w_s * (sig_seed - sigma)) * zeta
        eta = vwhere(active, eta2, eta)
        pi_new = vwhere(active, pi_new2, pi_new)
        zeta = vwhere(active, zeta2, zeta)
        alpha = set_at(vwhere(active, alpha_sh, alpha), seed, a_s)
        r_new = vfma(q, -w_s, y)                # :156
        dot_r, rTr_new = comm.dots((r_new, r_new), (r_hat, r_new))  # :157-159
        b_s = (a_s / w_s) * (rTr_new / rTr)     # :163
        p_set = sc.row_set(p_set, seed,
                        vfma(r_new, b_s, vfma(p_seed, -w_s, s)))  # :164-166
        # shift p part (:168-174), with the UPDATED zeta
        ratio = pi_old / pi_new
        beta_sh = ratio * ratio * b_s
        p_set = scale_add(p_set, sc.coeff(active, beta_sh, 1.0),
                          sc.coeff(active, 1.0 / (pi_new * zeta)),
                          r_new[None, :])
        beta = set_at(vwhere(active, beta_sh, beta), seed, b_s)
        # per-shift convergence (:184-203)
        abs_zp = torch.where(not_seed, vvalue(vabs(1.0 / (zeta * pi_new))),
                             1.0)
        if not exact:   # tol == 0: never stop a shift (base.exact_iters)
            stop = stop | (~stop & (abs_zp * abs_zp * vvalue(dot_r)
                                    <= tol2 * vvalue(dot_zero)))
        hist[k] = vvalue(dot_r)
        r, rTr = r_new, rTr_new
        k += 1
    relres = torch.sqrt(vvalue(dot_r) / vvalue(dot_zero))
    scale = torch.where(not_seed, vvalue(vabs(1.0 / (zeta * pi_new))), 1.0)
    true_rr = seed_true_relres(spmv, comm, b, sig_seed,
                               sc.take_row(x_set, seed), dot_zero)
    return ShiftedResult(x_set=x_set, n_iter=k, final_relres=relres,
                         history=torch.sqrt(hist / vvalue(dot_zero)),
                         stop_flags=stop, final_seed=seed,
                         shift_relres=scale * relres, true_relres=true_rr)


def init_switching_carry(b, sigma, seed: int, cfg: ShiftedConfig,
                         comm=None, shift_comm=None):
    """The seed-switching solver's initial carry
    (shifted_switching_solver.c:297-364), the 16-slot tuple

        (k, seed, x_set, p_set, r, eta, zeta, zp_eff, pi_arc, alpha_arc,
         beta_arc, omega_arc, stop, rTr, dot_r, hist)

    with k and seed Python ints, as the JAX package's carry orders its
    leaves. comm=None gives zeros of the right kind in the rTr and dot_r
    slots (a template for checkpoint loading). Under a shift_comm the
    slabs are this sigma group's [S/G, n] rows."""
    sigma = _as_sigma(sigma, b)
    S, n = sigma.shape[0], b.shape[0]
    S_loc = as_shift_comm(shift_comm).s_local(S)
    M = cfg.max_iter                   # archives sized M + 1 (:297-299)
    x_set = vzeros((S_loc, n), b)
    p_set = vbroadcast_rows(b, S_loc)           # :348
    eta = vzeros((S,), b)                       # :351
    zeta = vones((S,), b)                       # :354
    pi_arc = vones((M + 1, S), b)               # :352-353 (rows 0, 1 = 1)
    alpha_arc = vones((M + 1,), b)              # :363 alpha_arc[0] = 1
    beta_arc = vzeros((M + 1,), b)              # :364 beta_arc[0] = 0
    omega_arc = vones((M + 1,), b)              # [0] never read
    stop = torch.zeros(S, dtype=torch.bool, device=b.device)
    hist = hist_init(cfg, b)
    # the last LIVE zeta*pi of each shift (its full residual scale, frozen
    # at stop time): carrying the product, not pi alone, keeps the
    # estimate right for shifts that stopped before a switch reset zeta
    zp_eff = vones((S,), b)
    rTr = comm.dot(b, b) if comm is not None else vzeros((), b)  # :344-345
    return (1, int(seed), x_set, p_set, b, eta, zeta, zp_eff, pi_arc,
            alpha_arc, beta_arc, omega_arc, stop, rTr, rTr, hist)


# Named positions in the 16-slot carry. External consumers (the
# checkpoint segment driver) read through these accessors.
_CARRY_K = 0           # next iteration index (1-based, :297-299)
_CARRY_STOP = 12       # per-shift stop flags [S] bool


def carry_k(carry) -> int:
    """Next iteration index of a switching carry."""
    return int(carry[_CARRY_K])


def carry_stop_flags(carry):
    """Per-shift stop flags [S] of a switching carry."""
    return carry[_CARRY_STOP]


def switch_seed(cfg, sigma, seed: int, ms: int, k: int, r, eta, zeta,
                zp_eff, pi_arc, a_arc, b_arc, w_arc, stop):
    """Rebase the scalar history onto shift `ms` as the new seed after
    iteration k (shifted_switching_solver.c:490-527). pi_arc is rewritten
    in place; returns (ms, r, eta, zeta, zp_eff, pi_arc, a_arc, b_arc,
    w_arc)."""
    S = stop.shape[0]
    dev = stop.device
    if cfg.verbose_switch:
        # the reference prints switch diagnostics unconditionally
        # (shifted_switching_solver.c:519-526); here opt-in
        print(f"seed switch at iter {k}: seed {seed} -> {ms}")
    idxS = torch.arange(S, device=dev)
    idxM = torch.arange(pi_arc.shape[0], device=dev)
    dsig = sigma[seed] - sigma[ms]
    ratio = vcat([vones((1,), a_arc), pi_arc[:-1, ms] / pi_arc[1:, ms]])
    mask_i = (idxM >= 1) & (idxM <= k)
    a2 = vwhere(mask_i, a_arc * ratio, a_arc)                   # :495
    b2 = vwhere(mask_i, b_arc * ratio * ratio, b_arc)           # :496
    w2 = vwhere(mask_i, w_arc / (1.0 - w_arc * dsig), w_arc)    # :497
    zp_ms = zeta[ms] * pi_arc[k, ms]
    r2 = r / zp_ms                                              # :499
    eta2 = vzeros(eta.shape, eta)                               # :502
    zeta2 = vones(zeta.shape, zeta)                             # :504
    recompute = ~stop & (idxS != ms)                            # :511-512
    dsig_all = sigma[ms] - sigma
    for i in range(1, k + 1):                                   # :509-517
        e = (b2[i - 1] / a2[i - 1]) * a2[i] * eta2 \
            - dsig_all * a2[i] * pi_arc[i - 1]                  # :513
        p_i = e + pi_arc[i - 1]                                 # :514
        z = (1.0 - w2[i] * dsig_all) * zeta2                    # :515
        eta2 = vwhere(recompute, e, eta2)
        zeta2 = vwhere(recompute, z, zeta2)
        set_at(pi_arc, i, vwhere(recompute, p_i, pi_arc[i]))
    # rebase the frozen scales into the new seed's basis: collinearity
    # r_j = r_old / zp_j and r2 = r_old / zp_ms give zp_j / zp_ms; live
    # shifts get freshly recomputed values; the OLD seed had zp = 1
    zp2 = vwhere(recompute, zeta2 * pi_arc[k], zp_eff / zp_ms)
    set_at(zp2, seed, 1.0 / zp_ms)
    return ms, r2, eta2, zeta2, zp2, pi_arc, a2, b2, w2


def worst_remaining(stop, not_seed, abs_zp) -> int:
    """The remaining non-seed shift with the largest |1/(zeta pi)|
    (:470-473); the first one on a tie, as jnp.argmax picks it."""
    return host_read(torch.argmax(torch.where(~stop & not_seed, abs_zp,
                                              float("-inf"))))


def print_seed_relres(cfg, k: int, dot_r, dot_zero) -> None:
    if cfg.out_iter and k % cfg.out_iter == 0:
        print(f"iter {k}: seed relres "
              f"{float(torch.sqrt(vvalue(dot_r) / vvalue(dot_zero))):.6e}")


def seed_step(spmv, comm, r_hat, sigma, seed: int, k: int, x_set, p_set,
              r, rTr, eta, zeta, zp_eff, pi_arc, a_arc, b_arc, w_arc, stop,
              sc):
    """Iteration k of the seed-switching solve up to the [S, n] shift
    update (shifted_switching_solver.c:376-475): the seed's LOP-BiCGStab
    step and the shift recurrences. The per-iteration and the blocked
    loops share it and differ only in how they apply the update.

    Writes the seed rows of x_set / p_set and the archives at k in place.
    Returns (q, r_new, dot_r, rTr_new, coeffs, eta, zeta, zp_eff, abs_zp,
    not_seed), with coeffs the [S] vectors (cxp, cxq, cpq, cpr, m1, m2) of

        x' = x + (cxp p + cxq q);  p' = m1 (p + (cpq q + cpr r_old)) + m2 r_new

    and the active mask folded in: inactive rows get (0, 0, 0, 0, 1, 0),
    an exact identity (the form the fused shift update takes). sc (a
    parallel.sigma.SigmaComm) addresses the seed rows of the slabs; the
    coefficients stay the replicated [S] vectors."""
    S = stop.shape[0]
    sig_seed = sigma[seed]
    not_seed = torch.arange(S, device=stop.device) != seed
    active = not_seed & ~stop
    with span("mbt.seed_step"):
        p_seed = sc.take_row(p_set, seed)
        # --- seed iteration (one LOP-BiCGStab step on A + sig_seed I) ---
        s = spmv(p_seed) + sig_seed * p_seed         # :379-387
        rTs = comm.dot(r_hat, s)                     # :388
        a_k = rTr / rTs                              # :391
        set_at(a_arc, k, a_k)
        q = vfma(r, -a_k, s)                         # :392
        y = spmv(q) + sig_seed * q                   # :396-404
        qTq, qTy = comm.dots((q, q), (q, y))         # :405-406
        w_k = qTq / qTy                              # :410
        set_at(w_arc, k, w_k)
        sc.row_add(x_set, seed, vfma(a_k * p_seed, w_k, q))        # :411-412
        r_new = vfma(q, -w_k, y)                     # :413
        dot_r, rTr_new = comm.dots((r_new, r_new), (r_hat, r_new))  # :414-416
        b_k = (a_k / w_k) * (rTr_new / rTr)          # :420
        set_at(b_arc, k, b_k)
        sc.row_set(p_set, seed,
                   vfma(r_new, b_k, vfma(p_seed, -w_k, s)))   # :421-423
    with span("mbt.shift_recur"):
        # --- shift recurrences (:429-445) ---
        pi_prev = pi_arc[k - 1]                      # pi_archive[j, k-1]
        eta2 = (b_arc[k - 1] / a_arc[k - 1]) * a_k * eta \
            - (sig_seed - sigma) * a_k * pi_prev                # :432
        pi_k = eta2 + pi_prev                                   # :434
        alpha_sh = (pi_prev / pi_k) * a_k                       # :435
        omega_sh = w_k / (1.0 - w_k * (sig_seed - sigma))       # :436
        zeta2 = (1.0 - w_k * (sig_seed - sigma)) * zeta         # :441
        ratio = pi_prev / pi_k
        beta_sh = ratio * ratio * b_k                           # :442
        zero_s, one_s = vzeros((S,), r), vones((S,), r)
        coeffs = (   # x: :437-438; p stage 1: :439-440; p stage 2: :443-444
            vwhere(active, alpha_sh, zero_s),
            vwhere(active, omega_sh / (pi_k * zeta), zero_s),
            vwhere(active, omega_sh / (alpha_sh * zeta * pi_k), zero_s),
            vwhere(active, -(omega_sh / (alpha_sh * zeta * pi_prev)), zero_s),
            vwhere(active, beta_sh, one_s),
            vwhere(active, 1.0 / (pi_k * zeta2), zero_s))
        eta = vwhere(active, eta2, eta)
        zeta = vwhere(active, zeta2, zeta)
        zp_eff = vwhere(active, zeta2 * pi_k, zp_eff)
        set_at(pi_arc, k, vwhere(active, pi_k, pi_arc[k]))
        abs_zp = torch.where(not_seed, vvalue(vabs(1.0 / (zeta * pi_arc[k]))),
                             1.0)
    return (q, r_new, dot_r, rTr_new, coeffs, eta, zeta, zp_eff, abs_zp,
            not_seed)


def stop_test(stop, abs_zp, dot_r, tol2, dot_zero, seed: int):
    """Per-shift convergence (:450-475) and the one host read of the stop
    flags per iteration, which serves the loop condition (:374) and the
    switch test (:490). Returns (stop, done, switch_pending)."""
    stop = stop | (~stop & (abs_zp * abs_zp * vvalue(dot_r)
                            <= tol2 * vvalue(dot_zero)))
    stop_h = host_read(stop.cpu)
    done = bool(stop_h.all())
    return stop, done, bool(stop_h[seed]) and not done


def _switching_loop(spmv, comm, b, sigma, cfg: ShiftedConfig, carry,
                    k_stop: int, shift_comm=None):
    """Run the seed-switching loop from `carry` until every shift stops,
    k passes max_iter, or k reaches k_stop (segmented runs for
    checkpoint/resume). Returns the final carry. The arithmetic is
    bit-identical however the run is segmented: the carry is the complete
    solver state. The carry's state is updated in place."""
    sigma = _as_sigma(sigma, b)
    sc = as_shift_comm(shift_comm)
    tol2, exact, _ = start(b, cfg)
    M = cfg.max_iter
    dot_zero = comm.dot(b, b)                    # :344-345
    (k, seed, x_set, p_set, r, eta, zeta, zp_eff, pi_arc, a_arc, b_arc,
     w_arc, stop, rTr, dot_r, hist) = carry
    k, seed = int(k), int(seed)
    done = (not exact) and host_read(stop.all())  # :374; tol 0 reads nothing
    while not done and k < M + 1 and k < k_stop:
        with span("mbt.iter"):     # its stop test and any switch included
            r_old = r                                # :376
            (q, r_new, dot_r, rTr_new, c, eta, zeta, zp_eff, abs_zp,
             not_seed) = seed_step(spmv, comm, b, sigma, seed, k, x_set,
                                   p_set, r, rTr, eta, zeta, zp_eff, pi_arc,
                                   a_arc, b_arc, w_arc, stop,
                                   sc)              # r_hat = b (:346)
            # the coefficients of this sigma group's slab rows
            c = [sc.loc(v) for v in c]
            if is_df(x_set):
                # all three stages in ONE in-place pass
                # (ops/cuda_shift_update.py)
                x_set, p_set = fused_shift_update_df(x_set, p_set, q, r_old,
                                                     r_new, *c)
            else:
                cxp, cxq, cpq, cpr, m1, m2 = (v[:, None] for v in c)
                x_set = add_update(x_set, cxp, p_set, cxq,
                                   q[None, :])                 # :437-438
                p_set = add_update(p_set, cpq, q[None, :], cpr,
                                   r_old[None, :])             # :439-440
                p_set = scale_add(p_set, m1, m2, r_new[None, :])  # :443-444
            if not exact:   # tol == 0: no per-shift stop, no seed switch
                stop, done, pend = stop_test(stop, abs_zp, dot_r, tol2,
                                             dot_zero, seed)
                if pend:    # seed switching (:490-527)
                    ms = worst_remaining(stop, not_seed, abs_zp)
                    (seed, r_new, eta, zeta, zp_eff, pi_arc, a_arc, b_arc,
                     w_arc) = switch_seed(cfg, sigma, seed, ms, k, r_new, eta,
                                          zeta, zp_eff, pi_arc, a_arc, b_arc,
                                          w_arc, stop)
            hist[k - 1] = vvalue(dot_r)
            print_seed_relres(cfg, k, dot_r, dot_zero)
            r, rTr = r_new, rTr_new
            k += 1
    return (k, seed, x_set, p_set, r, eta, zeta, zp_eff, pi_arc, a_arc,
            b_arc, w_arc, stop, rTr, dot_r, hist)


def _switching_finish(out, spmv, comm, b, sigma,
                      shift_comm=None) -> ShiftedResult:
    """Carry -> ShiftedResult (the reference's exit prints, :555-598)."""
    sigma = _as_sigma(sigma, b)
    sc = as_shift_comm(shift_comm)
    S = sigma.shape[0]
    dot_zero = comm.dot(b, b)
    (k, seed, x_set, _p, _r, _eta, _zeta, zp_eff, _pi, _aa, _ba, _wa,
     stop, _rTr, dot_r, hist) = out
    relres = torch.sqrt(vvalue(dot_r) / vvalue(dot_zero))
    # per-shift estimated residuals (DISPLAY_SIGMA_RESIDUAL parity);
    # zp_eff holds each shift's LAST LIVE zeta*pi
    scale = torch.where(torch.arange(S, device=b.device) != seed,
                        vvalue(vabs(1.0 / zp_eff)), 1.0)
    true_rr = seed_true_relres(spmv, comm, b, sigma[seed],
                               sc.take_row(x_set, seed), dot_zero)
    return ShiftedResult(x_set=x_set, n_iter=int(k) - 1,  # :559 reports k-1
                         final_relres=relres,
                         history=torch.sqrt(hist / vvalue(dot_zero)),
                         stop_flags=stop, final_seed=int(seed),
                         shift_relres=scale * relres, true_relres=true_rr)


def shifted_lopbicg_switching(spmv, comm, b, sigma, seed: int,
                              cfg: ShiftedConfig,
                              shift_comm=None) -> ShiftedResult:
    """Seed-switching shifted solver (shifted_switching_solver.c:260-608).

    A float32 ladder on the card runs its shift updates BLOCKED: L
    iterations of [S, n] updates deferred and applied as [S, L] @ [L, n]
    matrix products (solvers/switching_blocked.py; cfg.shift_block). The
    per-iteration path (f64, df32, the CPU, and the segmented checkpoint
    driver always) is the reference-exact build. shift_comm (a
    parallel.sigma.SigmaComm) shards the ladder's slabs over sigma
    groups."""
    from mpi_bicgstab_tpu_torch.solvers.switching_blocked import (
        blocked_switching_loop, resolve_block)
    carry0 = init_switching_carry(b, sigma, seed, cfg, comm=comm,
                                  shift_comm=shift_comm)
    L = resolve_block(cfg, b, int(_as_sigma(sigma, b).shape[0]))
    if L:
        out = blocked_switching_loop(spmv, comm, b, sigma, cfg, carry0, L,
                                     shift_comm=shift_comm)
    else:
        out = _switching_loop(spmv, comm, b, sigma, cfg, carry0,
                              k_stop=cfg.max_iter + 1,
                              shift_comm=shift_comm)
    return _switching_finish(out, spmv, comm, b, sigma, shift_comm)


def shifted_lopbicg_switching_segment(spmv, comm, b, sigma,
                                      cfg: ShiftedConfig, carry, k_stop):
    """One SEGMENT of the seed-switching solve: run from `carry` until k
    reaches k_stop (or the solve ends). Returns (ShiftedResult, carry).
    Feeding the carry back into another segment reproduces the
    uninterrupted solve BIT-EXACTLY: the carry is the complete loop state
    (serialise it with utils.checkpoint.save_carry / load_carry). The
    given carry's state is updated in place."""
    out = _switching_loop(spmv, comm, b, sigma, cfg, carry,
                          k_stop=int(k_stop))
    return _switching_finish(out, spmv, comm, b, sigma), out


SWITCHING_SOLVERS = {
    "shifted_lopbicg": shifted_lopbicg,
    "shifted_lopbicg_switching": shifted_lopbicg_switching,
}
