"""The blocked distributed batch: k right-hand sides solved together on a
row partition, the lanes advancing in lockstep (counterpart of the JAX
package's vmap of the classic solver inside shard_map,
mpi_bicgstab_tpu/parallel/driver.py `_go_batched`).

Two loops, both classic BiCGStab (reference solver.c:35-146 per lane),
both with the per-lane freezing of solvers/batched_fused._Lanes (a
stopped lane keeps its vectors and scalars, its n_iter and history stop,
so every lane's trajectory is the one it would take alone) and one
stacked reduction per reduction point for all lanes ([D, k] partials
reduced over the row group in rank order, parallel/comm.Comm): 3 per
iteration, not 3 k.

* bicgstab_batched_halo: the halo-fused route, float32 on a pure-DIA
  halo partition with k <= 8 lanes and no preconditioner (`applicable`):
  the three fused batched passes of ops/cuda_fused_batched.py in their
  halo form, as solvers/fused_dist.py runs the single-lane passes. Every
  [k, n_loc] plane carries `halo` rows of each neighbour on either side;
  one batch of point-to-point messages refreshes the [k, h] edges of r
  before K1b (its p is fresh: K1b's stage 0 forms p' over the halo rows,
  and s was refreshed before the last K2b) and of s' before K2b (r is
  still fresh). r0 = B - A X0 and the exit true residuals take the
  batched SpMV's halo form (kernel 19). On one rank the planes carry no
  halo, every pass reads the columns [0, n) and every reduction is over
  one rank: the solve is the single-device
  solvers/batched_fused.bicgstab_batched_fully_fused, bit for bit.

* bicgstab_blocked: float32 / float64 bicgstab on any other partition
  (or with a preconditioner): an unfused loop over [k, n_loc] blocks,
  the rank's composed distributed SpMV applied lane by lane inside the
  iteration, the dots and scalar recurrences batched over the lanes.

df32 and the other methods solve lane by lane (parallel/driver.py).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mpi_bicgstab_tpu_torch.ops.cuda_batched_spmv import (MAX_DIAGS,
                                                          MAX_LANES,
                                                          batched_dia_spmv)
from mpi_bicgstab_tpu_torch.ops.cuda_fused_batched import (fused_k1b,
                                                           fused_k2b,
                                                           fused_k3b)
from mpi_bicgstab_tpu_torch.ops.cuda_spmv import Halo
from mpi_bicgstab_tpu_torch.ops.precision import is_df
from mpi_bicgstab_tpu_torch.parallel.dist_spmv import exchange_planes
from mpi_bicgstab_tpu_torch.solvers.base import SolveResult, start
from mpi_bicgstab_tpu_torch.solvers.batched_fused import _dot, _Lanes


def applicable(shard, method: str, B_loc, cfg, precond=None) -> bool:
    """Does this rank's batched solve take the halo-fused route? The
    single-device batch's routing (api._solve_batched_once): float32
    bicgstab on a pure-DIA halo partition, 1 <= k <= 8 lanes, no
    preconditioner, not under cfg.serialize_comm. Every rank holds a
    shard of the same partition, so every rank decides alike."""
    if method != "bicgstab" or precond is not None or cfg.serialize_comm:
        return False
    if shard.dia_vals is None or shard.dia_mode != "halo":
        return False
    if any(b is not None for b in (shard.window, shard.bfly, shard.blocks)):
        return False
    return (not is_df(B_loc) and B_loc.dtype == torch.float32
            and shard.dia_vals.dtype == torch.float32
            and 1 <= B_loc.shape[0] <= MAX_LANES
            and len(shard.dia_offsets) <= MAX_DIAGS)


def blocked(method: str, B_loc) -> bool:
    """Does a batched solve that is not halo-fused take the blocked
    unfused loop? bicgstab in float32 or float64."""
    return method == "bicgstab" and not is_df(B_loc) \
        and B_loc.dtype in (torch.float32, torch.float64)


class _Planes:
    """One rank's [k, n_loc] planes in their halo form: h rows of each
    neighbour around the rank's rows (none on one rank)."""

    def __init__(self, shard, comm):
        ranks = comm.size if comm.group is not None else 1
        self.comm = comm
        self.h = shard.halo if ranks > 1 else 0
        self.halo = Halo(self.h, comm.rank > 0, comm.rank < ranks - 1) \
            if ranks > 1 else None

    def ext(self, X):
        """X's rows in a new halo-form plane, zeros around them."""
        return X if self.halo is None else F.pad(X, (self.h, self.h))

    def c(self, X):
        """The rank's own rows of a halo-form plane."""
        return X if self.halo is None else X[:, self.h:X.shape[1] - self.h]

    def edges(self, *planes) -> None:
        """The neighbours' edge rows into the planes' halos, in one
        batch."""
        if self.halo is not None and self.h \
                and (self.halo.prev or self.halo.next):
            self.comm.seq(exchange_planes(self.comm, self.h,
                                          planes)).wait()

    def reduce(self, *dots):
        """The global values of a pass's per-lane dots ([k] each): one
        rank-ordered reduction of their [D, k] stack."""
        return list(self.comm.allreduce(torch.stack(dots)).unbind())


def bicgstab_batched_halo(shard, comm, B, X0, cfg) -> SolveResult:
    """Three halo-fused batched passes per iteration per rank (module
    doc). B and X0 are the rank's [k, n_loc] rows; the result's x is the
    rank's rows, its other fields per lane."""
    vals, offsets = shard.dia_vals, shard.dia_offsets
    G = _Planes(shard, comm)
    tol2, exact, _ = start(B, cfg)

    def spmv(Xc):
        """A X over the rank's rows (kernel 19, its halo form)."""
        if G.halo is None:
            return batched_dia_spmv(vals, offsets, Xc)
        Xh = G.ext(Xc)
        G.edges(Xh)
        return batched_dia_spmv(vals, offsets, Xh, G.halo)

    R0 = B - spmv(X0)                                   # solver.c:74-75
    (rTr0,) = G.reduce(_dot(R0, R0))                    # solver.c:78-80
    dot_zero = rTr0
    lanes = _Lanes(dot_zero, tol2, exact, cfg.max_iter)
    zk = torch.zeros_like(rTr0)
    R = R_hat = G.ext(R0)                               # solver.c:76
    X, P, S = G.ext(X0), G.ext(torch.zeros_like(R0)), \
        G.ext(torch.zeros_like(R0))
    beta = omega = zk
    rTr = dot_r = rTr0
    while (a := lanes.active(dot_r)) is not None:
        ab = a > 0.5
        G.edges(R)
        P2, S2, rhTs = fused_k1b(vals, R, P, S, R_hat, (beta, omega, a),
                                 offsets, G.halo)       # solver.c:88-91
        (rhTs,) = G.reduce(rhTs)
        alpha = torch.where(ab, rTr / rhTs, zk)         # solver.c:93
        G.edges(S2)
        Q, Y, qTy, yTy = fused_k2b(vals, R, S2, (alpha,), offsets,
                                   G.halo)              # solver.c:94-102
        qTy, yTy = G.reduce(qTy, yTy)
        omega2 = torch.where(ab, qTy / yTy, zk)         # solver.c:104
        X, R, dot_new, rTr_new = fused_k3b(X, P2, Q, Y, R_hat,
                                           (alpha, omega2, a),
                                           G.halo)      # solver.c:105-114
        dot_new, rTr_new = G.reduce(dot_new, rTr_new)
        beta = torch.where(ab, (alpha / omega2) * (rTr_new / rTr),
                           beta)                        # solver.c:116
        omega = torch.where(ab, omega2, omega)
        rTr = torch.where(ab, rTr_new, rTr)
        dot_r = torch.where(ab, dot_new, dot_r)
        P, S = P2, S2
        lanes.record(ab, dot_new)
    return lanes.result(G.c(X).contiguous(), B, dot_r, dot_zero, tol2,
                        spmv, reduce=lambda d: G.reduce(d)[0])


def bicgstab_blocked(spmv, comm, B, X0, cfg) -> SolveResult:
    """Classic BiCGStab over the rank's [k, n_loc] block (module doc):
    `spmv` is the rank's distributed SpMV of one lane, applied to each
    lane in turn; the reduction points of solver.c:89-114, each one
    stacked reduction for all lanes."""
    tol2, exact, _ = start(B, cfg)

    def spmv_lanes(X):
        return torch.stack([spmv(X[j]) for j in range(X.shape[0])])

    def reduce(*dots):
        return list(comm.allreduce(torch.stack(dots)).unbind())

    def keep(ab, new, old):
        return torch.where(ab[:, None], new, old)

    R0 = B - spmv_lanes(X0)                             # solver.c:74-75
    (rTr0,) = reduce(_dot(R0, R0))                      # solver.c:78-80
    dot_zero = rTr0
    lanes = _Lanes(dot_zero, tol2, exact, cfg.max_iter)
    zk = torch.zeros_like(rTr0)
    X, R, R_hat, P = X0, R0, R0, R0                     # solver.c:76-77
    rTr = dot_r = rTr0
    while (a := lanes.active(dot_r)) is not None:
        ab = a > 0.5
        S = spmv_lanes(P)                               # solver.c:88
        (rTs,) = reduce(_dot(R_hat, S))                 # solver.c:89-91
        alpha = torch.where(ab, rTr / rTs, zk)          # solver.c:93
        Q = R - alpha[:, None] * S                      # solver.c:94
        Y = spmv_lanes(Q)                               # solver.c:96
        qTy, yTy = reduce(_dot(Q, Y), _dot(Y, Y))       # solver.c:97-102
        omega = torch.where(ab, qTy / yTy, zk)          # solver.c:104
        X = keep(ab, X + alpha[:, None] * P + omega[:, None] * Q,
                 X)                                     # solver.c:105-106
        R_new = Q - omega[:, None] * Y                  # solver.c:107
        dot_new, rTr_new = reduce(_dot(R_new, R_new),
                                  _dot(R_hat, R_new))   # solver.c:108-114
        beta = (alpha / omega) * (rTr_new / rTr)        # solver.c:116
        P = keep(ab, R_new + beta[:, None] * (P - omega[:, None] * S),
                 P)                                     # solver.c:117-119
        R = keep(ab, R_new, R)
        rTr = torch.where(ab, rTr_new, rTr)
        dot_r = torch.where(ab, dot_new, dot_r)
        lanes.record(ab, dot_new)
    return lanes.result(X, B, dot_r, dot_zero, tol2, spmv_lanes,
                        reduce=lambda d: reduce(d)[0])
