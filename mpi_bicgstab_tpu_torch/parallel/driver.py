"""Distributed solve driver (counterpart of
mpi_bicgstab_tpu/parallel/driver.py).

The port's equivalent of the reference's main()s run under mpirun:
partition the matrix (parallel/partition.py), hand each rank its shard,
and run a solver of solvers/ with a Comm over the row group, halo or
gathered SpMVs and rank-ordered dot reductions. The same solver code runs
here and on one device (api.py): only the Comm differs.

Every entry point is called collectively, on every rank of the world
parallel/launch.py started, with the same host partition and vectors;
each returns the GLOBAL x (or x_set) on every rank, as the JAX package's
global arrays are. Ranks beyond the grid return None. A Shard
(put_partitioned) may stand in for the partition, so that repeated solves
reuse the blocks already on the device.

solve_distributed routes as the JAX `_go` does: a float32 classic, CA or
pipelined solve (df32: classic) on a pure-DIA halo partition without a
preconditioner takes the halo-fused iterations of solvers/fused_dist.py,
the fused kernels' halo forms; every other solve the unfused solver over
the composed SpMV. The rank's Comm takes cfg.serialize_comm (the
no-overlap A/B, parallel/comm.py), under which every solve is unfused.
The batched form (solve_batched_distributed) advances its lanes together
(solvers/batched_dist.py): float32 bicgstab on a pure-DIA halo partition
with k <= 8 lanes runs the fused batched passes' halo forms, float32 /
float64 bicgstab elsewhere a blocked unfused loop, each with one
reduction per point for all lanes; df32 and the other methods solve lane
by lane.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpi_bicgstab_tpu_torch.ops.precision import (DF, df_add, df_from_f64,
                                                  is_df, vzeros_like)
from mpi_bicgstab_tpu_torch.parallel.comm import Comm
from mpi_bicgstab_tpu_torch.parallel.dist_spmv import (spmv_allgather,
                                                       spmv_dia_gather,
                                                       spmv_dia_halo,
                                                       spmv_ring)
from mpi_bicgstab_tpu_torch.parallel.mesh import (make_grid_mesh,
                                                  make_row_mesh)
from mpi_bicgstab_tpu_torch.parallel.partition import PartitionedMatrix
from mpi_bicgstab_tpu_torch.parallel.sigma import SigmaComm
from mpi_bicgstab_tpu_torch.solvers.base import SolveResult
from mpi_bicgstab_tpu_torch.solvers import batched_dist, fused_dist
from mpi_bicgstab_tpu_torch.solvers.bicgstab import CLASSIC_SOLVERS
from mpi_bicgstab_tpu_torch.utils.config import SolverConfig

HALOS = ("allgather", "ring")


def row_comm(mesh) -> Comm:
    """The Comm over this rank's row partition."""
    return Comm(mesh.rows, mesh.n_rows, mesh.row_index)


def _add(y, y2):
    if y is None:
        return y2
    return df_add(y, y2) if is_df(y) else y + y2


def make_local_spmv(shard, comm: Comm, halo_strategy: str = "allgather"):
    """The rank's SpMV x_loc -> y_loc, composed from the shard's blocks
    as the JAX package composes them: the DIA band (halo or gather mode),
    the windowed-ELL diag block, the butterfly row slab (over the
    gathered iterate, sliced to the rank's rows) and the diag / offd ELL
    blocks (allgather or ring)."""
    from mpi_bicgstab_tpu_torch.ops.butterfly_spmv import (
        butterfly_spmv, butterfly_spmv_df)
    from mpi_bicgstab_tpu_torch.ops.window_spmv import (window_spmv,
                                                        window_spmv_df)

    def spmv(x_loc):
        y = None
        if shard.dia_vals is not None:
            if shard.dia_mode == "halo":
                y = spmv_dia_halo(shard.dia_vals, shard.dia_offsets,
                                  shard.halo, comm, x_loc, shard.n_devices)
            else:
                y = spmv_dia_gather(shard.dia_vals, shard.dia_offsets, comm,
                                    x_loc)
        if shard.window is not None:
            fn = window_spmv_df if is_df(x_loc) else window_spmv
            y = _add(y, fn(shard.window, x_loc))
        if shard.bfly is not None:
            x_full = comm.allgather(x_loc)
            fn = butterfly_spmv_df if is_df(x_loc) else butterfly_spmv
            y = _add(y, fn(shard.bfly, x_full)[: shard.n_loc])
        if shard.blocks is not None:
            diag, offd = shard.blocks
            if halo_strategy == "ring":
                y2 = spmv_ring(diag, offd, comm, x_loc, shard.n_devices)
            else:
                # with the window layout carrying the diag block, the
                # diag slot is a zero-width placeholder: it adds zero
                y2 = spmv_allgather(diag, offd, comm, x_loc)
            y = _add(y, y2)
        return y

    return spmv


def pad_vector(v, n_global: int) -> np.ndarray:
    v = np.asarray(v)
    if v.shape[0] == n_global:
        return v
    out = np.zeros((n_global,) + v.shape[1:], dtype=v.dtype)
    out[: v.shape[0]] = v
    return out


def put_vector(v, part, mesh):
    """This rank's slice of the host vector v (zero-padded to n_global),
    on its device in the partition's dtype (a pair for df32)."""
    r = mesh.row_index
    v = pad_vector(v, part.n_global)[r * part.n_loc:(r + 1) * part.n_loc]
    if part.dtype == "df32":
        return df_from_f64(np.asarray(v, np.float64), mesh.device)
    return torch.as_tensor(np.ascontiguousarray(v), dtype=part.dtype,
                           device=mesh.device)


def put_partitioned(part: PartitionedMatrix, mesh):
    """This rank's blocks on its device (each rank holds only its own
    shard, like an MPI rank after loading)."""
    return part.shard(mesh.row_index, mesh.device)


def _grid(part, mesh, halo: str, sigma_devices: int = 1):
    """(mesh, shard, comm) of this rank, after JAX's checks; shard None
    for a rank beyond the grid."""
    if halo not in HALOS:
        raise ValueError(f"unknown halo strategy {halo!r}")
    if sigma_devices > 1:
        mesh = mesh or make_grid_mesh(part.n_devices, sigma_devices)
        if (mesh.n_rows, mesh.n_sigma) != (part.n_devices, sigma_devices):
            raise ValueError(f"mesh {mesh.shape} does not match "
                             f"rows={part.n_devices} x "
                             f"sigma={sigma_devices}")
    else:
        mesh = mesh or make_row_mesh(part.n_devices)
        if mesh.size != part.n_devices:
            raise ValueError(f"mesh has {mesh.size} devices but the matrix "
                             f"was partitioned for {part.n_devices}")
    if not mesh.member:
        return mesh, None, None
    if isinstance(part, PartitionedMatrix):
        return mesh, put_partitioned(part, mesh), row_comm(mesh)
    if part.rank != mesh.row_index or part.device != mesh.device:
        raise ValueError(f"the shard of rank {part.rank} on "
                         f"{part.device} is not this rank's (row "
                         f"{mesh.row_index} on {mesh.device})")
    return mesh, part, row_comm(mesh)


def _precond_spmv(spmv, precond):
    """v -> A p(A) v over the distributed SpMV (the halo exchanges
    compose: no new communication pattern)."""
    from mpi_bicgstab_tpu_torch.ops.cheby import cheby_apply
    return lambda v: spmv(cheby_apply(spmv, v, precond.degree, precond.lo,
                                      precond.hi))


def _exit_transform(spmv, precond, x):
    """x = p(A) y, once per solve."""
    from mpi_bicgstab_tpu_torch.ops.cheby import cheby_apply
    return cheby_apply(spmv, x, precond.degree, precond.lo, precond.hi)


def _once(method, spmv, comm, b_loc, cfg, shard=None):
    """once(x0, cfg): one solver segment without restarts; given the
    rank's shard, on the halo-fused route where fused_dist.applicable
    takes it (every segment alike)."""
    fused = shard is not None and fused_dist.applicable(shard, method,
                                                        b_loc, cfg)

    def once(x0, c):
        if fused:
            return fused_dist.solve_fused_dist(shard, comm, method, spmv,
                                               b_loc, x0, c)
        return CLASSIC_SOLVERS[method](spmv, comm, b_loc, x0, c)
    return once


def _classic(method, spmv, comm, b_loc, x0_loc, cfg, shard=None):
    """One solve with the refinement restarts of api.solve (_once)."""
    from mpi_bicgstab_tpu_torch.api import _restarted
    once = _once(method, spmv, comm, b_loc, cfg, shard)
    res = once(x0_loc, cfg)
    if cfg.restarts:
        res = _restarted(once, cfg, res)
    return res


def _check_method(method: str, precond):
    if method not in CLASSIC_SOLVERS:
        raise ValueError(f"unknown method {method!r}")
    return precond.resolve() if precond is not None else None


def make_dist_spmv(part, mesh=None, halo: str = "allgather"):
    """A global-view distributed SpMV f(x_global) -> y_global (host
    vectors in, the global y on every rank's device out), for tests and
    the nnz/s benchmark; call f on every rank."""
    mesh, shard, comm = _grid(part, mesh, halo)
    if shard is None:
        return lambda x: None
    spmv = make_local_spmv(shard, comm, halo)
    return lambda x: comm.allgather(spmv(put_vector(x, part, mesh)))


def spmv_global(part, x, mesh=None, halo: str = "allgather"):
    """y = A x once through make_dist_spmv (host x; the global y on every
    rank's device): a task for launch.run and launch.Pool."""
    return make_dist_spmv(part, mesh, halo)(x)


def solve_distributed(part, b, x0=None, method: str = "bicgstab",
                      cfg: SolverConfig | None = None, mesh=None,
                      halo: str = "allgather", precond=None,
                      unfused: bool = False) -> SolveResult:
    """Distributed solve of A x = b over the row grid.

    precond: an ops.cheby.ChebyPrecond with lo/hi SET (bounds cannot be
    estimated from a partition: compute them from the host CSR with
    ops.cheby.estimate_bounds before partitioning). Right-preconditioned:
    residuals are the original system's; x = p(A) y runs once at exit.
    unfused: take the unfused solver where the halo-fused route would
    apply (the overlapped side of benchmarks/runner.bench_overlap, which
    cfg.serialize_comm's side takes by rule)."""
    precond = _check_method(method, precond)
    mesh, shard, comm = _grid(part, mesh, halo)
    if shard is None:
        return None
    dtype = part.dtype
    if cfg is None:
        cfg = SolverConfig(dtype=dtype)
    comm = comm.with_serialize(cfg.serialize_comm)
    spmv = make_local_spmv(shard, comm, halo)
    op = _precond_spmv(spmv, precond) if precond is not None else spmv
    b_loc = put_vector(b, part, mesh)
    x0_loc = put_vector(x0, part, mesh) if x0 is not None \
        else vzeros_like(b_loc)
    res = _classic(method, op, comm, b_loc, x0_loc, cfg,
                   shard if precond is None and not unfused else None)
    x = res.x if precond is None else _exit_transform(spmv, precond, res.x)
    return dataclasses.replace(res, x=comm.allgather(x))


def put_planes(B, part, mesh):
    """This rank's columns of the host [k, n] B (zero-padded to n_global),
    on its device in the partition's dtype (a pair for df32)."""
    r = mesh.row_index
    Bp = np.zeros((B.shape[0], part.n_global))
    Bp[:, : B.shape[1]] = B
    Bl = np.ascontiguousarray(Bp[:, r * part.n_loc:(r + 1) * part.n_loc])
    if part.dtype == "df32":
        return df_from_f64(Bl, mesh.device)
    return torch.as_tensor(Bl, dtype=part.dtype, device=mesh.device)


def solve_batched_distributed(part, B, method: str = "bicgstab",
                              cfg: SolverConfig | None = None, mesh=None,
                              halo: str = "allgather",
                              precond=None) -> SolveResult:
    """Distributed batched solve: B is [k, n] (host float64). The lanes
    advance together as the JAX package's vmapped lanes do
    (solvers/batched_dist.py; a stopped lane freezes there, so each lane's
    trajectory is its own): float32 bicgstab on a pure-DIA halo partition
    with k <= 8 lanes and no preconditioner on the halo-fused batched
    passes, float32 / float64 bicgstab otherwise in the blocked unfused
    loop, each with one reduction per point for all lanes; df32 and the
    other methods lane by lane with the unfused solver. Then the per-lane
    refinement restarts of api.solve_batched, each lane on its own through
    solve_distributed's route, and the Chebyshev exit transform per lane,
    in the JAX package's order (driver.py:383-404). The result's fields
    carry a leading batch axis (x [k, n_global] on every rank)."""
    from mpi_bicgstab_tpu_torch.api import _restart_batch_lanes, _stack_lanes
    precond = _check_method(method, precond)
    B = np.asarray(B, np.float64)
    if B.ndim != 2:
        raise ValueError(f"B must be [k, n], got shape {B.shape}")
    mesh, shard, comm = _grid(part, mesh, halo)
    if shard is None:
        return None
    dtype = part.dtype
    if cfg is None:
        cfg = SolverConfig(dtype=dtype)
    comm = comm.with_serialize(cfg.serialize_comm)
    spmv = make_local_spmv(shard, comm, halo)
    op = _precond_spmv(spmv, precond) if precond is not None else spmv
    B_loc = put_planes(B, part, mesh)
    k = B.shape[0]

    def lane(j):
        return B_loc[j] if not is_df(B_loc) else DF(B_loc.hi[j],
                                                    B_loc.lo[j])

    if batched_dist.applicable(shard, method, B_loc, cfg, precond):
        res = batched_dist.bicgstab_batched_halo(
            shard, comm, B_loc, torch.zeros_like(B_loc), cfg)
    elif batched_dist.blocked(method, B_loc):
        res = batched_dist.bicgstab_blocked(op, comm, B_loc,
                                            torch.zeros_like(B_loc), cfg)
    else:
        res = None
    if res is not None:
        if cfg.restarts:
            seg_shard = shard if precond is None else None

            def segment(j, x0, c):
                return _once(method, op, comm, lane(j), c, seg_shard)(x0, c)
            res = _restart_batch_lanes(segment, cfg, res)
        X = res.x
        if precond is not None:
            X = torch.stack([_exit_transform(spmv, precond, X[j])
                             for j in range(k)])
        return dataclasses.replace(res, x=comm.allgather(X, axis=1))
    lanes = []
    for j in range(k):
        b_loc = lane(j)
        r = _classic(method, op, comm, b_loc, vzeros_like(b_loc), cfg)
        x = r.x if precond is None \
            else _exit_transform(spmv, precond, r.x)
        lanes.append(dataclasses.replace(r, x=comm.allgather(x)))
    return _stack_lanes(lanes)


def solve_shifted_distributed(part, b, sigma, seed: int = 0,
                              method: str = "shifted_lopbicg_switching",
                              cfg=None, mesh=None, halo: str = "allgather",
                              sigma_devices: int = 1):
    """Distributed multi-shift solve: (A + sigma_j I) x_j = b for the
    whole ladder from one Krylov sequence. sigma_devices > 1 adds the
    sigma axis (parallel/sigma.py): part.n_devices * sigma_devices ranks
    as a rows x sigma grid, each holding [S / sigma_devices, n_loc] of the
    state, with trajectories bit-identical to sigma_devices = 1 at the
    same row count. x_set is the global [S, n_global] on every rank."""
    from mpi_bicgstab_tpu_torch.api import _all_shifted_solvers, _ladder
    from mpi_bicgstab_tpu_torch.utils.config import ShiftedConfig
    sigma_devices = int(sigma_devices)
    if sigma_devices < 1:
        raise ValueError(f"sigma_devices must be >= 1, got {sigma_devices}")
    sig_h = np.asarray(sigma.hi if hasattr(sigma, "hi") else sigma)
    S = sig_h.shape[0]
    if S % sigma_devices:
        raise ValueError(f"sigma_len {S} not divisible by sigma_devices "
                         f"{sigma_devices}")
    solvers = _all_shifted_solvers()
    if method not in solvers:
        raise ValueError(f"unknown method {method!r}")
    if not (0 <= seed < S):
        raise ValueError(f"seed {seed} out of range for {S} shifts")
    mesh, shard, comm = _grid(part, mesh, halo, sigma_devices)
    if shard is None:
        return None
    dtype = part.dtype
    if cfg is None:
        cfg = ShiftedConfig(dtype=dtype)
    comm = comm.with_serialize(cfg.serialize_comm)
    sc = None
    if sigma_devices > 1:
        sc = SigmaComm(Comm(mesh.sigma, mesh.n_sigma, mesh.sigma_index),
                       sigma_devices)
    spmv = make_local_spmv(shard, comm, halo)
    b_loc = put_vector(b, part, mesh)
    sig = _ladder(b_loc, sigma)
    fn = solvers[method]
    if method == "shifted_bicgstab":
        res = fn(spmv, comm, b_loc, sig, cfg, shift_comm=sc)
    else:
        res = fn(spmv, comm, b_loc, sig, int(seed), cfg, shift_comm=sc)
    x_set = comm.allgather(res.x_set, axis=1)
    if sc is not None:
        x_set = sc.comm.allgather(x_set)
    return dataclasses.replace(res, x_set=x_set)


def _local_set(x_set, part, mesh):
    """This rank's columns of a global [S, n_global] set (tensors, a pair
    or host arrays), on its device."""
    r = mesh.row_index
    cols = slice(r * part.n_loc, (r + 1) * part.n_loc)

    def one(h, dt):
        return torch.as_tensor(h)[:, cols].to(mesh.device, dt).contiguous()

    if part.dtype == "df32":
        return DF(one(x_set.hi, torch.float32), one(x_set.lo, torch.float32))
    return one(x_set, part.dtype)


def refine_shifted_distributed(part, b, sigma, x_set, cfg=None, mesh=None,
                               halo: str = "allgather", chunk: int = 128):
    """Distributed per-shift refinement: the [S, n] state row-sharded,
    per-row dots reduced over the row group, ladders wider than `chunk`
    in chunks. Returns (x_set global, n_iter, true_relres [S])."""
    from mpi_bicgstab_tpu_torch.api import _ladder
    from mpi_bicgstab_tpu_torch.ops.precision import vcat
    from mpi_bicgstab_tpu_torch.solvers.refine import refine_shifted
    mesh, shard, comm = _grid(part, mesh, halo)
    if shard is None:
        return None
    dtype = part.dtype
    if cfg is None:
        cfg = SolverConfig(tol=1e-10, max_iter=500, dtype=dtype)
    spmv = make_local_spmv(shard, comm, halo)
    b_loc = put_vector(b, part, mesh)
    sig = _ladder(b_loc, sigma)
    xs = _local_set(x_set, part, mesh)
    S = sig.shape[0]
    outs, iters, rels = [], 0, []
    for s0 in range(0, S, chunk):
        sl = slice(s0, min(s0 + chunk, S))
        x2, k, rr = refine_shifted(spmv, comm, b_loc, sig[sl], xs[sl], cfg)
        outs.append(x2)
        iters = max(iters, int(k))
        rels.append(rr)
    x_out = outs[0] if len(outs) == 1 else vcat(outs, 0)
    return (comm.allgather(x_out, axis=1), iters,
            rels[0] if len(rels) == 1 else torch.cat(rels))
