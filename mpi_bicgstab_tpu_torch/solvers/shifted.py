"""Shifted-system (multi-sigma) BiCGStab solvers (counterpart of
mpi_bicgstab_tpu/solvers/shifted.py).

Solve (A + sigma_j I) x_j = b for a whole ladder of shifts from ONE
Krylov sequence: only the seed system does SpMVs and global dots; every
other shift is vector work driven by scalar recurrences (collinearity of
shifted residuals). Three algorithms (reference src/shifted_solver.c):

  shifted_bicgstab         :13-180. Seed = the UNSHIFTED system (index 0
                           implicitly, s = A p[0], :90); xi/tau recurrences.
  shifted_lopbicgstab      :182-354. Seed = (A + sigma_seed I); pi/eta/zeta
                           recurrences (:283-289), shifted omega (:298),
                           omega_seed = (q,q)/(q,y) (:293). The reference's
                           _v2 (:357-529) and _nooverlap (:531-701) are the
                           same math and are aliases.
  shifted_pipe_lopbicgstab :703-895. Pipelined seed iteration (s, z, w, v,
                           t) with the same shift recurrences; _nooverlap
                           (:897-1086) is an alias.

The shift axis is the leading dimension of the [S, n] x_set / p_set
state; the shift recurrences are [S] vector arithmetic and the state
updates masked rank-1 updates (coefficient columns times the shared seed
vectors), plain PyTorch on either device. On tensors the state updates
run in place (x_set += ..., p_set *= ...), which gives the out-of-place
expression's bits without its [S, n] temporaries; on double-float pairs
they are the DF operators' expressions. The seed row is excluded by the
mask and updated with its own BiCGStab formulas.

Stopping mirrors the reference: the shifted residual is ESTIMATED as
|scale_j| ||r_seed|| (never recomputed), scale_j = xi_curr tau
(shifted_bicgstab, :140) or 1/(zeta pi) (LOP variants, :316); the loop
exits when max_j |scale_j|^2 (r,r) <= tol^2 (r0,r0). That test is one host
read per iteration; tol == 0 runs exactly max_iter iterations and reads
nothing.
"""
from __future__ import annotations

import numpy as np
import torch

from mpi_bicgstab_tpu_torch.ops.precision import (_as_df, is_df, vabs,
                                                  vbroadcast_rows, vfma,
                                                  vones, vvalue, vwhere,
                                                  vzeros)
from mpi_bicgstab_tpu_torch.parallel.sigma import as_shift_comm
from mpi_bicgstab_tpu_torch.solvers.base import ShiftedResult, start
from mpi_bicgstab_tpu_torch.utils.config import ShiftedConfig


def hist_init(cfg, b) -> torch.Tensor:
    return torch.full((cfg.max_iter,), float("nan"), dtype=b.dtype,
                      device=b.device)


def _as_sigma(sigma, b):
    """The shift ladder in the working arithmetic (DF iff b is DF) on b's
    device. A DF sigma (split host-side from float64, api.py) passes
    through; anything else becomes a tensor of b's dtype, promoted to a
    pair with zero lo parts for a DF b."""
    if is_df(sigma):
        return sigma
    if not torch.is_tensor(sigma):
        sigma = torch.as_tensor(np.asarray(sigma))
    sigma = sigma.to(device=b.device, dtype=b.dtype)
    return _as_df(sigma) if is_df(b) else sigma


def set_at(v, i: int, val):
    """v[i] = val in place (the JAX `.at[i].set`); v is a fresh [S]
    vector. Returns v."""
    if is_df(v):
        val = _as_df(val, v)
        v.hi[i] = val.hi
        v.lo[i] = val.lo
    else:
        v[i] = val
    return v


def _running_max(abs_scale, mask):
    """max(1, max_j over mask of abs_scale_j), NaN-propagating."""
    m = torch.where(mask, abs_scale, 0.0).max()
    return torch.maximum(m, torch.ones_like(m))


def add_update(x_set, c1, p_set, c2, v):
    """x_set + (c1 p_set + c2 v) with [S, 1] coefficient columns and a
    [1, n] row v; in place on tensors."""
    if is_df(x_set):
        return x_set + vfma(c1 * p_set, c2, v)
    t = c1 * p_set
    t += c2 * v
    x_set += t
    return x_set


def scale_add(p_set, c1, c2, v):
    """c1 p_set + c2 v; in place on tensors."""
    if is_df(p_set):
        return vfma(c1 * p_set, c2, v)
    p_set.mul_(c1)
    p_set += c2 * v
    return p_set


def _sub_update(p_set, cq, q, cr, r):
    """p_set + (cq q - cr r); in place on tensors."""
    if is_df(p_set):
        return p_set + (cq * q - cr * r)
    t = cq * q
    t -= cr * r
    p_set += t
    return p_set


def seed_true_relres(spmv, comm, b, sigma_seed, x_seed, dot_zero):
    """||b - (A + sigma_seed I) x_seed|| / ||r0||: one extra SpMV at exit
    on the CURRENT seed system, the decoupling detector for the whole
    ladder (solvers/base.ShiftedResult). sigma_seed is sigma[seed] for
    the LOP family, 0 for shifted_bicgstab's unshifted seed."""
    r_true = b - vfma(spmv(x_seed), sigma_seed, x_seed)
    td = comm.dot(r_true, r_true)
    return torch.sqrt(vvalue(td) / vvalue(dot_zero))


def _shift_result(x_set, k, dot_r, dot_zero, scale_abs, tol2, hist, seed,
                  spmv, comm, b, sigma_seed, sc):
    relres = torch.sqrt(vvalue(dot_r) / vvalue(dot_zero))
    history = torch.sqrt(hist / vvalue(dot_zero))
    stop = scale_abs * scale_abs * vvalue(dot_r) \
        <= tol2 * vvalue(dot_zero)
    true_rr = seed_true_relres(spmv, comm, b, sigma_seed,
                               sc.take_row(x_set, seed), dot_zero)
    return ShiftedResult(x_set=x_set, n_iter=k, final_relres=relres,
                         history=history, stop_flags=stop, final_seed=seed,
                         shift_relres=scale_abs * relres,
                         true_relres=true_rr)


def _go_on(exact, k, max_iter, scale_max, dot_r, tol2, dot_zero) -> bool:
    """The loop condition; the residual test (one host read) only when
    tol != 0."""
    if k >= max_iter:
        return False
    return exact or bool(scale_max * scale_max * dot_r > tol2 * dot_zero)


def shifted_bicgstab(spmv, comm, b, sigma, cfg: ShiftedConfig,
                     shift_comm=None) -> ShiftedResult:
    """Multi-shift BiCGStab with the UNSHIFTED A as seed (reference
    shifted_solver.c:13-180; seed index 0 by construction).

    The xi recurrence (:110): per shift j,
      xi_new = (xi_c xi_o a_old) /
               (a0 b_old (xi_o - xi_c) + xi_o a_old (1 + a0 sigma_j))
    maps the seed polynomial to the shifted one; tau (:132) accumulates
    the omega-stabiliser ratios."""
    sigma = _as_sigma(sigma, b)
    sc = as_shift_comm(shift_comm)
    S, n = sigma.shape[0], b.shape[0]
    S_loc = sc.s_local(S)
    tol2, exact, _ = start(b, cfg)
    mask = torch.arange(S, device=b.device) != 0

    r_hat = b                                   # :72 (r = b, x0 = 0)
    rTr = comm.dot(b, b)                        # :70-71
    dot_zero = dot_r = rTr
    x_set = vzeros((S_loc, n), b)
    p_set = vbroadcast_rows(b, S_loc)               # :74 p[j] = b
    alpha = vones((S,), b)                      # :76
    beta = vzeros((S,), b)                      # :75
    tau = vones((S,), b)                        # :79
    xi_old = vones((S,), b)                     # :77
    xi_curr = vones((S,), b)                    # :78
    max_xi = torch.ones((), dtype=b.dtype, device=b.device)    # :86
    hist = hist_init(cfg, b)
    r, k = b, 0
    while _go_on(exact, k, cfg.max_iter, max_xi, dot_r, tol2, dot_zero):
        p_seed = sc.take_row(p_set, 0)
        s = spmv(p_seed)                        # :90 (unshifted)
        rTs = comm.dot(r_hat, s)                # :91
        # shift p part 1 (:92-96), mask folded into the coefficients
        ratio = xi_curr / xi_old
        beta_sh = ratio * ratio * beta[0]
        p_set = scale_add(p_set, sc.coeff(mask, beta_sh, 1.0),
                          sc.coeff(mask, tau * xi_curr), r[None, :])
        r_old = r                               # :97
        alpha_old, beta_old = alpha[0], beta[0]  # :98-99
        a0 = rTr / rTs                          # :102
        q = r - a0 * s                          # :104
        y = spmv(q)                             # :105
        qTy, yTy = comm.dots((q, y), (y, y))    # :107-108
        xi_new = (xi_curr * xi_old * alpha_old) / (     # :110-112
            a0 * beta_old * (xi_old - xi_curr)
            + xi_old * alpha_old * (1.0 + a0 * sigma))
        alpha_sh = (xi_new / xi_curr) * a0
        w0 = qTy / yTy                          # omega[0], :117
        x_set = sc.row_add(x_set, 0, vfma(a0 * p_seed, w0, q))  # :118-119
        # shift x / p part 2 (:120-126)
        omega_sh = w0 / (1.0 + w0 * sigma)      # :121
        x_set = add_update(x_set, sc.coeff(mask, alpha_sh), p_set,
                           sc.coeff(mask, omega_sh * tau * xi_new),
                           q[None, :])
        p_set = _sub_update(
            p_set, sc.coeff(mask, omega_sh * tau * xi_new / alpha_sh),
            q[None, :], sc.coeff(mask, omega_sh * tau * xi_curr / alpha_sh),
            r_old[None, :])
        r_new = q - w0 * y                      # :127
        dot_r, rTr_new = comm.dots((r_new, r_new), (r_hat, r_new))  # :128-130
        tau = vwhere(mask, tau / (1.0 + w0 * sigma), tau)           # :132
        b0 = (a0 / w0) * (rTr_new / rTr)        # :137
        # the stopping factor uses xi_curr BEFORE the rotation (:139-142)
        max_xi = _running_max(vvalue(vabs(xi_curr * tau)), mask)
        xi_old = vwhere(mask, xi_curr, xi_old)      # :143
        xi_curr = vwhere(mask, xi_new, xi_curr)     # :144
        p_set = sc.row_set(p_set, 0,
                        vfma(r_new, b0, vfma(p_seed, -w0, s)))  # :145-147
        alpha = set_at(vwhere(mask, alpha_sh, alpha), 0, a0)
        beta = set_at(vwhere(mask, beta_sh, beta), 0, b0)
        hist[k] = vvalue(dot_r)
        r, rTr = r_new, rTr_new
        k += 1
    scale = torch.where(mask, vvalue(vabs(xi_curr * tau)), 1.0)
    return _shift_result(x_set, k, dot_r, dot_zero, scale, tol2, hist, 0,
                         spmv, comm, b, vzeros((), b), sc)


def shifted_lopbicgstab(spmv, comm, b, sigma, seed: int,
                        cfg: ShiftedConfig,
                        shift_comm=None) -> ShiftedResult:
    """Shifted LOP-BiCGStab (reference shifted_solver.c:182-354). The seed
    system is (A + sigma[seed] I); shifts are RELATIVE: sigma[seed] -
    sigma[j] appears in every recurrence (:285, :298, :303).
    omega_seed = (q,q)/(q,y) (:293), the 'locally optimal' choice that
    keeps the shifted omega recurrence rational."""
    sigma = _as_sigma(sigma, b)
    sc = as_shift_comm(shift_comm)
    S, n = sigma.shape[0], b.shape[0]
    S_loc = sc.s_local(S)
    tol2, exact, _ = start(b, cfg)
    mask = torch.arange(S, device=b.device) != seed
    sig_seed = sigma[seed]

    r_hat = b                                   # :242
    rTr = comm.dot(b, b)                        # :240-241
    dot_zero = dot_r = rTr
    x_set = vzeros((S_loc, n), b)
    p_set = sc.row_set(vzeros((S_loc, n), b), seed, b)  # :252
    alpha = vones((S,), b)
    beta = vzeros((S,), b)
    eta = vzeros((S,), b)                       # :247
    zeta = vones((S,), b)                       # :250
    pi_old = vones((S,), b)                     # :248
    pi_new = vones((S,), b)                     # :249
    max_zp = torch.ones((), dtype=b.dtype, device=b.device)
    hist = hist_init(cfg, b)
    r, k = b, 0
    while _go_on(exact, k, cfg.max_iter, max_zp, dot_r, tol2, dot_zero):
        p_seed = sc.take_row(p_set, seed)
        s = spmv(p_seed) + sig_seed * p_seed             # :261-262
        rTs = comm.dot(r_hat, s)                         # :263
        # shift p part 1 (:264-269), mask folded into the coefficients
        ratio = pi_old / pi_new
        beta_sh = ratio * ratio * beta[seed]
        p_set = scale_add(p_set, sc.coeff(mask, beta_sh, 1.0),
                          sc.coeff(mask, 1.0 / (pi_new * zeta)), r[None, :])
        pi_old = pi_new                                  # :270
        r_old = r                                        # :271
        alpha_old, beta_old = alpha[seed], beta[seed]    # :272-273
        a_s = rTr / rTs                                  # :276
        q = vfma(r, -a_s, s)                             # :277
        y = spmv(q) + sig_seed * q                       # :278-279
        qTq, qTy = comm.dots((q, q), (q, y))             # :281-282
        # pi / eta recurrence (:283-289)
        eta2 = (beta_old / alpha_old) * a_s * eta \
            - (sig_seed - sigma) * a_s * pi_old
        pi_new2 = eta2 + pi_old
        alpha_sh = (pi_old / pi_new2) * a_s
        eta = vwhere(mask, eta2, eta)
        pi_new = vwhere(mask, pi_new2, pi_new)
        w_s = qTq / qTy                                  # :293
        x_set = sc.row_add(x_set, seed,
                        vfma(a_s * p_seed, w_s, q))    # :294-295
        # shift x / p part 2 (:296-304)
        omega_sh = w_s / (1.0 - w_s * (sig_seed - sigma))    # :298
        x_set = add_update(x_set, sc.coeff(mask, alpha_sh), p_set,
                           sc.coeff(mask, omega_sh / (pi_new2 * zeta)),
                           q[None, :])
        p_set = _sub_update(
            p_set, sc.coeff(mask, omega_sh / (alpha_sh * zeta * pi_new2)),
            q[None, :],
            sc.coeff(mask, omega_sh / (alpha_sh * zeta * pi_old)),
            r_old[None, :])
        zeta = vwhere(mask, (1.0 - w_s * (sig_seed - sigma)) * zeta,
                      zeta)                              # :303
        r_new = vfma(q, -w_s, y)                         # :305
        dot_r, rTr_new = comm.dots((r_new, r_new), (r_hat, r_new))  # :306-308
        b_s = (a_s / w_s) * (rTr_new / rTr)              # :312
        max_zp = _running_max(vvalue(vabs(1.0 / (zeta * pi_new2))), mask)
        p_set = sc.row_set(p_set, seed,
                        vfma(r_new, b_s, vfma(p_seed, -w_s, s)))  # :319-321
        alpha = set_at(vwhere(mask, alpha_sh, alpha), seed, a_s)
        beta = set_at(vwhere(mask, beta_sh, beta), seed, b_s)
        hist[k] = vvalue(dot_r)
        r, rTr = r_new, rTr_new
        k += 1
    scale = torch.where(mask, vvalue(vabs(1.0 / (zeta * pi_new))), 1.0)
    return _shift_result(x_set, k, dot_r, dot_zero, scale, tol2, hist,
                         seed, spmv, comm, b, sig_seed, sc)


# The reference's reordered / no-overlap twins are the same recurrences:
shifted_lopbicgstab_v2 = shifted_lopbicgstab            # ref :357-529
shifted_lopbicgstab_nooverlap = shifted_lopbicgstab     # ref :531-701


def shifted_pipe_lopbicgstab(spmv, comm, b, sigma, seed: int,
                             cfg: ShiftedConfig,
                             shift_comm=None) -> ShiftedResult:
    """Shifted PIPELINED LOP-BiCGStab (reference shifted_solver.c:703-895).
    The seed iteration is the pipelined BiCGStab recurrence (s, z, w, v, t;
    alpha by the rational update :859); the shift updates are the LOP
    variant's pi/eta/zeta recurrences."""
    sigma = _as_sigma(sigma, b)
    sc = as_shift_comm(shift_comm)
    S, n = sigma.shape[0], b.shape[0]
    S_loc = sc.s_local(S)
    tol2, exact, _ = start(b, cfg)
    mask = torch.arange(S, device=b.device) != seed
    sig_seed = sigma[seed]

    def sspmv(v):                               # :765-770
        return spmv(v) + sig_seed * v

    r_hat = b                                   # :772
    rTr = comm.dot(b, b)                        # :763
    w = sspmv(b)                                # :765-766
    rTw0 = comm.dot(b, w)                       # :767
    t = sspmv(w)                                # :769-770
    dot_zero = dot_r = rTr
    a_s = rTr / rTw0                            # :787
    a_old = vones((), b)                        # :786
    b_s = vzeros((), b)
    w_s = vzeros((), b)
    x_set = vzeros((S_loc, n), b)
    p_set = sc.row_set(vzeros((S_loc, n), b), seed, b)  # :782
    z, s, v = vzeros((n,), b), vzeros((n,), b), vzeros((n,), b)
    eta = vzeros((S,), b)
    zeta = vones((S,), b)
    pi_old = vones((S,), b)
    pi_new = vones((S,), b)
    max_zp = torch.ones((), dtype=b.dtype, device=b.device)
    hist = hist_init(cfg, b)
    r, k = b, 0
    while _go_on(exact, k, cfg.max_iter, max_zp, dot_r, tol2, dot_zero):
        p_seed = r + b_s * (sc.take_row(p_set, seed)
                            - w_s * s)                   # :795-797
        p_set = sc.row_set(p_set, seed, p_seed)
        s = w + b_s * (s - w_s * z)                      # :798-800
        z = t + b_s * (z - w_s * v)                      # :801-803
        # shift p part 1 (:804-809), mask folded into the coefficients
        ratio = pi_old / pi_new
        beta_sh = ratio * ratio * b_s
        p_set = scale_add(p_set, sc.coeff(mask, beta_sh, 1.0),
                          sc.coeff(mask, 1.0 / (pi_new * zeta)), r[None, :])
        r_old = r                                        # :810
        q = r - a_s * s                                  # :811
        y = w - a_s * z                                  # :812
        qTy, yTy = comm.dots((q, y), (y, y))             # :813-814
        v = sspmv(z)                                     # :815-816
        pi_old = pi_new                                  # :817
        beta_old = b_s                                   # :818
        # shift recurrence (:819-825); a_old is the PREVIOUS iteration's
        # seed alpha (:858 updates it at the iteration's end)
        eta2 = (beta_old / a_old) * a_s * eta \
            - (sig_seed - sigma) * a_s * pi_old
        pi_new2 = eta2 + pi_old
        alpha_sh = (pi_old / pi_new2) * a_s
        eta = vwhere(mask, eta2, eta)
        pi_new = vwhere(mask, pi_new2, pi_new)
        w_s = qTy / yTy                                  # :829
        x_set = sc.row_add(x_set, seed, a_s * p_seed + w_s * q)  # :830-831
        # shift x / p part 2 (:832-840)
        omega_sh = w_s / (1.0 - w_s * (sig_seed - sigma))        # :834
        x_set = add_update(x_set, sc.coeff(mask, alpha_sh), p_set,
                           sc.coeff(mask, omega_sh / (pi_new2 * zeta)),
                           q[None, :])
        p_set = _sub_update(
            p_set, sc.coeff(mask, omega_sh / (alpha_sh * zeta * pi_new2)),
            q[None, :],
            sc.coeff(mask, omega_sh / (alpha_sh * zeta * pi_old)),
            r_old[None, :])
        zeta = vwhere(mask, (1.0 - w_s * (sig_seed - sigma)) * zeta,
                      zeta)                              # :839
        r_new = q - w_s * y                              # :841
        w = y - w_s * (t - a_s * v)                      # :843-844
        dot_r, rTr_new, rhTw, rhTs, rhTz = comm.dots(
            (r_new, r_new), (r_hat, r_new), (r_hat, w),
            (r_hat, s), (r_hat, z))                      # :842, :846-849
        t = sspmv(w)                                     # :850-851
        b_s = (a_s / w_s) * (rTr_new / rTr)              # :857
        a_old = a_s                                      # :858
        a_s = rTr_new / (rhTw + b_s * (rhTs - w_s * rhTz))  # :859
        max_zp = _running_max(vvalue(vabs(1.0 / (zeta * pi_new2))), mask)
        hist[k] = vvalue(dot_r)
        r, rTr = r_new, rTr_new
        k += 1
    scale = torch.where(mask, vvalue(vabs(1.0 / (zeta * pi_new))), 1.0)
    return _shift_result(x_set, k, dot_r, dot_zero, scale, tol2, hist,
                         seed, spmv, comm, b, sig_seed, sc)


shifted_pipe_lopbicgstab_nooverlap = shifted_pipe_lopbicgstab  # ref :897-1086


SHIFTED_SOLVERS = {
    "shifted_bicgstab": shifted_bicgstab,
    "shifted_lopbicgstab": shifted_lopbicgstab,
    "shifted_lopbicgstab_v2": shifted_lopbicgstab_v2,
    "shifted_lopbicgstab_nooverlap": shifted_lopbicgstab_nooverlap,
    "shifted_pipe_lopbicgstab": shifted_pipe_lopbicgstab,
    "shifted_pipe_lopbicgstab_nooverlap": shifted_pipe_lopbicgstab_nooverlap,
}
