"""Halo-fused distributed classic-family iterations (counterpart of
mpi_bicgstab_tpu/solvers/fused_dist.py).

On a row-partitioned DIA operator in halo mode (parallel/partition.py) the
fused passes of ops/cuda_fused_classic.py, ops/cuda_fused_ca.py and
ops/cuda_fused_pipe.py (float32) and ops/cuda_fused_classic_df.py (df32
classic) run in their halo form (ops/cuda_spmv.Halo). Each rank keeps its
vectors with `halo` entries of its neighbours' edge rows before and after
its own rows, refreshes the edges of a pass's band inputs with one batch
of point-to-point exchanges before the pass (parallel/dist_spmv.
exchange_halo; the ends of the matrix read none), and reduces the pass's
dots over the row group in rank order (parallel/comm.Comm). A pass
recomputes a neighbour's p', q, s' or r' from the exchanged inputs, as the
JAX kernels form them over their halo rows, so the in-kernel band multiply
needs no other synchronisation.

Per iteration, classic: 2 exchanges (r and p before K1, s' before K2; r's
edges are still fresh for K2, so 3 vectors where the JAX loop moves 5) and
3 reductions; CA: 2 exchanges (w, s, z; q, y) and 2 reductions; pipelined:
2 exchanges (z'; w') and 2 reductions. The set-up SpMVs (r0, w0, t0), a
residual-replacement iteration and the exit true residual use the composed
distributed SpMV (parallel/driver.make_local_spmv). On one rank every pass
reads the columns [0, n) and every reduction is the identity: the solve is
the single-device fused driver's, bit for bit.

`applicable` is the JAX gate: a pure-DIA halo partition, no
preconditioner, no serialize_comm, float32 for bicgstab, ca_bicgstab,
pipe_bicgstab and pipe_bicgstab_rr, df32 for bicgstab only (the JAX
package's DF CA and pipelined kernels have no halo form either); also
out_iter 0, as for the single-device fused routes (api._solve_once). The
JAX gate's n_loc % 8192 (its tile grid) and its backend test have no
counterpart: the kernels take any n, and the route is the same on the
CPU (the plain twins, gloo) as on the card.
"""
from __future__ import annotations

import torch

from mpi_bicgstab_tpu_torch.ops import cuda_fused_ca as fca
from mpi_bicgstab_tpu_torch.ops import cuda_fused_classic as fcl
from mpi_bicgstab_tpu_torch.ops import cuda_fused_classic_df as fcldf
from mpi_bicgstab_tpu_torch.ops import cuda_fused_pipe as fpipe
from mpi_bicgstab_tpu_torch.ops.blas import axpy
from mpi_bicgstab_tpu_torch.ops.cuda_spmv import Halo, center
from mpi_bicgstab_tpu_torch.ops.precision import (DF, is_df, vvalue,
                                                  vzeros_like)
from mpi_bicgstab_tpu_torch.parallel.dist_spmv import exchange_halo
from mpi_bicgstab_tpu_torch.solvers.base import (finish, fold_beta_alpha,
                                                 is_rr, start)

F32_METHODS = ("bicgstab", "ca_bicgstab", "pipe_bicgstab",
               "pipe_bicgstab_rr")


def applicable(shard, method: str, b_loc, cfg, precond=None) -> bool:
    """Does this rank's solve take the halo-fused route? Every rank holds
    a shard of the same partition, so every rank decides alike. Never
    under cfg.serialize_comm: the no-overlap A/B times the unfused
    solvers (JAX fused_dist.py:67)."""
    if precond is not None or cfg.out_iter or cfg.serialize_comm:
        return False
    if shard.dia_vals is None or shard.dia_mode != "halo":
        return False
    if any(b is not None for b in (shard.window, shard.bfly, shard.blocks)):
        return False
    if is_df(b_loc):
        return method == "bicgstab" and is_df(shard.dia_vals)
    return (method in F32_METHODS and b_loc.dtype == torch.float32
            and shard.dia_vals.dtype == torch.float32)


class _Rows:
    """One rank's halo-form vectors: n_loc rows with `halo` entries of
    each neighbour's edge rows around them."""

    def __init__(self, shard, comm):
        ranks = comm.size if comm.group is not None else 1
        self.h, self.n, self.comm = shard.halo, shard.n_loc, comm
        self.halo = Halo(shard.halo, comm.rank > 0, comm.rank < ranks - 1)

    def ext(self, v):
        """v's rows in a new halo-form vector, zeros around them."""
        halves = []
        for t in ((v.hi, v.lo) if is_df(v) else (v,)):
            e = t.new_zeros(self.n + 2 * self.h)
            e[self.h:self.h + self.n] = t
            halves.append(e)
        return DF(*halves) if is_df(v) else halves[0]

    def c(self, v):
        """The rank's own rows of a halo-form vector."""
        return center(v, self.halo)

    def edges(self, *vecs) -> None:
        """The neighbours' edge rows into vecs' halos, in one batch."""
        if self.h and (self.halo.prev or self.halo.next):
            self.comm.seq(exchange_halo(
                self.comm, self.h, [(self.c(v), v) for v in vecs])).wait()

    def reduce(self, *dots):
        """The global values of a pass's dots: one rank-ordered
        reduction (a pair's halves together)."""
        if is_df(dots[0]):
            d = self.comm.allreduce(DF(torch.stack([t.hi for t in dots]),
                                       torch.stack([t.lo for t in dots])))
            return [DF(d.hi[k], d.lo[k]) for k in range(len(dots))]
        return list(self.comm.allreduce(torch.stack(dots)).unbind())


def bicgstab_fused_halo(shard, comm, spmv, b, x0, cfg):
    """Classic BiCGStab, three halo-fused passes per iteration per rank
    (reference solver.c:35-146; the single-device driver is
    ops/cuda_fused_classic.bicgstab_fused, the JAX one
    fused_dist.bicgstab_fused_halo)."""
    vals, offsets = shard.dia_vals, shard.dia_offsets
    R = _Rows(shard, comm)
    tol2, exact, zero = start(b, cfg)
    r0 = b - spmv(x0)                                   # solver.c:74-75
    rTr0 = comm.dot(r0, r0)                             # solver.c:78-80
    dot_zero = rTr0
    r = r_hat = R.ext(r0)                               # solver.c:76
    x, p, s = R.ext(x0), R.ext(vzeros_like(r0)), R.ext(vzeros_like(r0))
    beta = omega = zero
    rTr = dot_r = rTr0
    hist = []
    thresh = None if exact else float(dot_zero * tol2)
    k = 0
    while k < cfg.max_iter and (exact or float(dot_r) > thresh):  # :86
        R.edges(r, p)
        p2, s2, rhTs = fcl.fused_k1(vals, r, p, s, r_hat, (beta, omega),
                                    offsets, R.halo)
        (rhTs,) = R.reduce(rhTs)                        # solver.c:89-91
        alpha = rTr / rhTs                              # solver.c:93
        R.edges(s2)
        q, y, qTy, yTy = fcl.fused_k2(vals, r, s2, (alpha,), offsets,
                                      R.halo)
        qTy, yTy = R.reduce(qTy, yTy)                   # solver.c:97-102
        omega2 = qTy / yTy                              # solver.c:104
        x, r, dot_r, rTr_new = fcl.fused_k3(x, p2, q, y, r_hat,
                                            (alpha, omega2), R.halo)
        dot_r, rTr_new = R.reduce(dot_r, rTr_new)       # solver.c:108-114
        beta = (alpha / omega2) * (rTr_new / rTr)       # solver.c:116
        p, s, omega, rTr = p2, s2, omega2, rTr_new
        hist.append(dot_r)
        k += 1
    return finish(R.c(x), k, dot_r, dot_zero, tol2, hist, cfg.max_iter,
                  spmv, comm, b)


def ca_bicgstab_fused_halo(shard, comm, spmv, b, x0, cfg):
    """CA-BiCGStab, two halo-fused passes per iteration per rank
    (reference solver.c:160-278; ops/cuda_fused_ca.ca_bicgstab_fused on
    one device, the JAX fused_dist.ca_bicgstab_fused_halo)."""
    vals, offsets = shard.dia_vals, shard.dia_offsets
    R = _Rows(shard, comm)
    tol2, exact, zero = start(b, cfg)
    r0 = b - spmv(x0)                                   # solver.c:200-201
    w0 = spmv(r0)                                       # solver.c:205
    rTr0, rTw0 = comm.dots((r0, r0), (r0, w0))          # solver.c:203-208
    alpha = rTr0 / rTw0                                 # solver.c:210
    beta = omega = zero                                 # solver.c:211
    r = r_hat = R.ext(r0)                               # solver.c:202
    x, w = R.ext(x0), R.ext(w0)
    p, s, z = (R.ext(vzeros_like(r0)) for _ in range(3))
    dot_zero = rTr = dot_r = rTr0
    hist = []
    thresh = None if exact else float(dot_zero * tol2)
    k = 0
    while k < cfg.max_iter and (exact or float(dot_r) > thresh):  # :216
        R.edges(w, s, z)
        p, s, z, q, y, qTy, yTy = fca.fused_ca_k1(
            vals, r, p, s, w, z, (alpha, beta, omega), offsets, R.halo)
        qTy, yTy = R.reduce(qTy, yTy)                   # solver.c:227-230
        omega = qTy / yTy                               # solver.c:232
        R.edges(q, y)
        x, r, w, *dots = fca.fused_ca_k2(vals, q, y, x, p, r_hat, s, z,
                                         (alpha, omega), offsets, R.halo)
        dot_r, rTr_new, rhTw, rhTs, rhTz = R.reduce(*dots)
        beta, alpha = fold_beta_alpha(alpha, omega, rTr, rTr_new, rhTw,
                                      rhTs, rhTz)       # solver.c:248-249
        hist.append(dot_r)
        rTr = rTr_new
        k += 1
    return finish(R.c(x), k, dot_r, dot_zero, tol2, hist, cfg.max_iter,
                  spmv, comm, b)


def pipe_bicgstab_fused_halo(shard, comm, spmv, b, x0, cfg,
                             rr: bool = False):
    """Pipelined BiCGStab (rr: with residual replacement every cfg.krr
    iterations, at most cfg.nrr times), two halo-fused phases per
    iteration per rank (reference solver.c:292-417 and 433-576;
    ops/cuda_fused_pipe._pipe_fused on one device, the JAX
    fused_dist.pipe_bicgstab_fused_halo). z' and w' are formed over the
    whole halo-form vectors, then their edges exchanged; a replacement
    iteration runs on the rank's rows through the distributed SpMV."""
    vals, offsets = shard.dia_vals, shard.dia_offsets
    R = _Rows(shard, comm)
    tol2, exact, zero = start(b, cfg)
    r0 = b - spmv(x0)                                   # solver.c:333-334
    w0 = spmv(r0)                                       # solver.c:338
    t0 = spmv(w0)                                       # solver.c:341
    rTr0, rTw0 = comm.dots((r0, r0), (r0, w0))          # solver.c:336-343
    alpha = rTr0 / rTw0                                 # solver.c:345
    beta = omega = zero
    r = r_hat = R.ext(r0)                               # solver.c:335
    x, w, t = R.ext(x0), R.ext(w0), R.ext(t0)
    p, s, z, v = (R.ext(vzeros_like(r0)) for _ in range(4))
    dot_zero = rTr = dot_r = rTr0
    hist = []
    thresh = None if exact else float(dot_zero * tol2)
    k = 0
    while k < cfg.max_iter and (exact or float(dot_r) > thresh):  # :351
        if rr and is_rr(k, cfg):
            # solver.c:494-539, on the rank's rows
            rc, wc = R.c(r), R.c(w)
            pc = axpy(beta, axpy(-omega, R.c(s), R.c(p)), rc)
            sc = spmv(pc)
            zc = spmv(sc)
            qc, yc = axpy(-alpha, sc, rc), axpy(-alpha, zc, wc)
            qTy, yTy = comm.dots((qc, yc), (yc, yc))
            vc = spmv(zc)
            omega = qTy / yTy
            xc = axpy(omega, qc, axpy(alpha, pc, R.c(x)))
            rc = b - spmv(xc)
            wc = spmv(rc)
            rh = R.c(r_hat)
            dot_r, rTr_new, rhTw, rhTs, rhTz = comm.dots(
                (rc, rc), (rh, rc), (rh, wc), (rh, sc), (rh, zc))
            tc = spmv(wc)
            p, s, z, v, x, r, w, t = (R.ext(u) for u in
                                      (pc, sc, zc, vc, xc, rc, wc, tc))
        else:
            z_new = axpy(beta, axpy(-omega, v, z), t)   # solver.c:358-360
            R.edges(z_new)
            v, p, s, q, y, qTy, yTy = fpipe.fused_phase_a(
                vals, z_new, r, p, s, w, z, (alpha, beta, omega), offsets,
                R.halo)
            z = z_new
            qTy, yTy = R.reduce(qTy, yTy)               # solver.c:363-367
            omega = qTy / yTy                           # solver.c:369
            w = axpy(-omega, axpy(-alpha, v, t), y)     # solver.c:374-375
            R.edges(w)
            t, x, r, *dots = fpipe.fused_phase_b(
                vals, w, x, p, q, y, r_hat, s, z, (alpha, omega), offsets,
                R.halo)
            dot_r, rTr_new, rhTw, rhTs, rhTz = R.reduce(*dots)
        beta, alpha = fold_beta_alpha(alpha, omega, rTr, rTr_new, rhTw,
                                      rhTs, rhTz)       # solver.c:387-388
        hist.append(dot_r)
        rTr = rTr_new
        k += 1
    return finish(R.c(x), k, dot_r, dot_zero, tol2, hist, cfg.max_iter,
                  spmv, comm, b)


def bicgstab_fused_df_halo(shard, comm, spmv, b, x0, cfg):
    """df32 classic BiCGStab, three halo-fused DF passes per iteration per
    rank (ops/cuda_fused_classic_df.bicgstab_fused_df on one device, the
    JAX fused_dist.bicgstab_fused_df_halo). Each pass's folded scalar
    comes from the rank's own dots: alpha, omega and beta are formed here
    from the reduced ones, with the twins' DF operators (ops/precision)."""
    vals, offsets = shard.dia_vals, shard.dia_offsets
    R = _Rows(shard, comm)
    tol2, exact, zero = start(b, cfg)
    r0 = b - spmv(x0)                                   # solver.c:74-75
    rTr0 = comm.dot(r0, r0)                             # solver.c:78-80
    dot_zero = rTr0
    r = r_hat = R.ext(r0)                               # solver.c:76
    x, p, s = R.ext(x0), R.ext(vzeros_like(r0)), R.ext(vzeros_like(r0))
    beta = omega = zero
    rTr = dot_r = rTr0
    hist = []
    thresh = None if exact else float(vvalue(dot_zero) * tol2)
    k = 0
    while k < cfg.max_iter and (exact or float(vvalue(dot_r)) > thresh):
        R.edges(r, p)
        p2, s2, rhTs, _ = fcldf.fused_k1_df(
            vals, r, p, s, r_hat, (beta, omega, rTr), offsets, R.halo)
        (rhTs,) = R.reduce(rhTs)                        # solver.c:89-91
        alpha = rTr / rhTs                              # solver.c:93
        R.edges(s2)
        q, y, qTy, yTy, _ = fcldf.fused_k2_df(vals, r, s2, (alpha,),
                                              offsets, R.halo)
        qTy, yTy = R.reduce(qTy, yTy)                   # solver.c:97-102
        omega2 = qTy / yTy                              # solver.c:104
        x, r, dot_r, rTr_new, _ = fcldf.fused_k3_df(
            x, p2, q, y, r_hat, (alpha, omega2, rTr), R.halo)
        dot_r, rTr_new = R.reduce(dot_r, rTr_new)       # solver.c:108-114
        beta = (alpha / omega2) * (rTr_new / rTr)       # solver.c:116
        p, s, omega, rTr = p2, s2, omega2, rTr_new
        hist.append(dot_r)
        k += 1
    return finish(R.c(x), k, dot_r, dot_zero, tol2, hist, cfg.max_iter,
                  spmv, comm, b, f32_test=True)


def solve_fused_dist(shard, comm, method: str, spmv, b_loc, x0_loc, cfg):
    """One solver pass on the halo-fused route (after `applicable`);
    `spmv` is the composed distributed SpMV, used for the set-up, the
    replacement iterations and the exit true residual."""
    if is_df(b_loc):
        return bicgstab_fused_df_halo(shard, comm, spmv, b_loc, x0_loc, cfg)
    if method in ("pipe_bicgstab", "pipe_bicgstab_rr"):
        return pipe_bicgstab_fused_halo(shard, comm, spmv, b_loc, x0_loc,
                                        cfg, rr=method == "pipe_bicgstab_rr")
    fn = bicgstab_fused_halo if method == "bicgstab" \
        else ca_bicgstab_fused_halo
    return fn(shard, comm, spmv, b_loc, x0_loc, cfg)
