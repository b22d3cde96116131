"""Command-line entry point (counterpart of mpi_bicgstab_tpu/cli.py; the
reference's main.c).

    python -m mpi_bicgstab_tpu_torch solve --matrix transport-like:1602112 \\
        --method pipe_bicgstab --dtype float32 --tol 1e-6
    python -m mpi_bicgstab_tpu_torch solve --matrix banded:4096 \\
        --dtype df32 --tol 1e-11 --device cpu

    python -m mpi_bicgstab_tpu_torch solve-shifted \\
        --matrix transport-like:1602112 --dtype df32 --sigma-len 512 \\
        --sigma-max 0.01 --seed 255 --tol 1e-10

    python -m mpi_bicgstab_tpu_torch solve --matrix banded:4096 \\
        --rhs-batch B.npy --dtype float32 --tol 1e-5 --device cpu

    python -m mpi_bicgstab_tpu_torch solve --matrix transport-hard:4096 \\
        --precond cheby:8 --device cpu

    python -m mpi_bicgstab_tpu_torch solve --matrix clustered:8192 \\
        --device cpu
    python -m mpi_bicgstab_tpu_torch solve --matrix uniform:8192 \\
        --device cpu

    python -m mpi_bicgstab_tpu_torch info
    python -m mpi_bicgstab_tpu_torch selftest --dtype float32
    python -m mpi_bicgstab_tpu_torch convert A.mtx A.npz
    python -m mpi_bicgstab_tpu_torch bench --matrix transport-like:1602112 \\
        --what spmv,iter,batched,cheby,shifted

`solve` methods: bicgstab, ca_bicgstab, pipe_bicgstab, pipe_bicgstab_rr (with
--krr/--nrr), bicgstab_l2, bicgstab_l4. Matrices: a .mtx / .mtx.gz /
.npz path, or a generator spec 'poisson2d:N', 'poisson3d:N',
'transport-like:N', 'transport-hard:N', 'banded:N', 'skew:N',
'clustered:N', 'uniform:N'. --reorder (default auto) permutes the matrix
with RCM when that moves it onto diagonals, --scale jacobi equilibrates it
(ops/reorder.py, ops/scale.py); --rhs, --x0 and --write-solution stay in
the original row order and scale. --format picks the device layout
(ops/layout.build_operator: 'auto' routes by structure analysis on the
matrix padded to a multiple of 1024, as the JAX CLI pads it; a
windowed-ELL or butterfly route is built on that padded matrix, a DIA or
hybrid one on the unpadded matrix; 'ell' takes any matrix); --layout-cache
DIR keeps built layouts for repeat solves (utils/opcache.py); --precond
cheby[:D[:LO:HI]] solves right-preconditioned with a degree-D Chebyshev
polynomial, its bounds estimated from the matrix unless given
(ops/cheby.py). The solve runs on the card unless --device cpu asks for
the CPU. It runs once untimed, then --repeat N times timed, as the JAX
CLI does, and prints the fields the JAX package's `solve` prints (one
JSON line of the JAX package's keys with --json) and exits 0 when the
solve converged, 2 when it did not. --checkpoint FILE saves the iterate
every --checkpoint-every iterations and resumes from it
(utils/checkpoint.py; with --devices N rank 0 reads and writes it).
`solve --rhs-batch B.npy` solves every row of a [k, n] array as a
right-hand side in one batched solve (api.solve_batched), prints the JAX
package's batched fields and exits 0 only when every lane converged. `solve-shifted` (reference
main_shifted.c) solves a ladder of shifted systems with the
seed-switching solver or another shifted method, prints the JAX
package's solve-shifted fields, and exits 0 when every shift converged,
2 otherwise. `info` prints what runs here, `selftest` checks every
solver family, layout and precision on a small system against ground
truth (exit 2 on any failure), `convert` writes a matrix as the binary
.npz container, and `bench` prints one JSON line of SpMV and iteration
times on the card, or on the CPU with --device cpu
(benchmarks/runner.run_bench; with --devices N, and for --what
overlap,scaling, over spawned ranks).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _load_matrix(spec: str):
    from mpi_bicgstab_tpu_torch.models import generators as G
    from mpi_bicgstab_tpu_torch.ops.sparse import load_csr

    t0 = time.perf_counter()
    if ":" in spec and not spec.lower().endswith((".mtx", ".mtx.gz",
                                                  ".npz")):
        kind, _, arg = spec.partition(":")
        n = int(arg)
        if kind == "poisson2d":
            csr = G.poisson2d(int(round(n ** 0.5)))
        elif kind == "poisson3d":
            csr = G.poisson3d(int(round(n ** (1 / 3))))
        elif kind == "transport-like":
            csr = G.transport_like(n)
        elif kind == "transport-hard":
            csr = G.transport_hard(n)
        elif kind == "banded":
            w = max(2, int(round(n ** (1 / 3))))
            csr = G.banded_random(n, [1, -1, w, -w, w * w, -w * w], seed=0)
        elif kind == "skew":
            # skew-dominant (convection-like) spectrum: the classic
            # family stagnates; use --method bicgstab_l2 / _l4
            csr = G.skew_banded(n)
        elif kind == "clustered":
            # unstructured but clustered (the windowed-ELL layout's
            # matrix); n rounds down to a multiple of 1024
            csr = G.clustered_random(max(n // 1024, 1) * 1024)
        elif kind == "uniform":
            # uniform random columns, no locality (the butterfly layout)
            csr = G.random_diag_dominant(n, nnz_per_row=8, seed=0)
        else:
            raise SystemExit(f"unknown generator {kind!r}")
    else:
        csr = load_csr(spec, dtype=np.float64)
    return csr, time.perf_counter() - t0


def _load_rhs(spec: str, n: int, flag: str = "--rhs") -> np.ndarray:
    """A user vector (right-hand side, or --x0): .npy, or a Matrix Market
    vector (array n x 1 or coordinate; duplicate coordinate entries
    sum)."""
    if spec.endswith(".npy"):
        b = np.load(spec)
    else:
        from mpi_bicgstab_tpu_torch.io.mmio import read_matrix_market
        rows, cols, vals, shape = read_matrix_market(spec)
        if 1 not in shape:
            raise SystemExit(f"{flag} {spec}: expected a vector, got "
                             f"{shape}")
        b = np.zeros(max(shape))
        np.add.at(b, rows if shape[1] == 1 else cols, vals)
    b = np.asarray(b, np.float64).ravel()
    if b.size != n:
        raise SystemExit(f"{flag} has {b.size} entries, matrix has {n} "
                         f"rows")
    return b


_SEED = 255         # main_shifted.c:14


# the JAX package's `solve` payload (JAX cli.py:453-478): --json prints
# these keys; the text report adds the port's device, layout and setup_s
SOLVE_JSON_KEYS = ("method", "matrix", "n", "nnz", "devices", "reordered",
                   "scaled", "precond", "io_time_s", "total_iter",
                   "final_relres", "true_relres", "converged",
                   "total_time_s", "avg_time_per_iter_s")


def _report(payload: dict, as_json: bool = False) -> None:
    if as_json:
        print(json.dumps(payload), flush=True)
        return
    for k, v in payload.items():
        print(f"{k:>16s}: {v}")


def _build_problem(csr, dtype, dev, fmt: str = "auto",
                   layout_cache: str | None = None, **kw):
    """build_problem in the layout --format asks for, padded as the JAX
    CLI would need it: the JAX CLI pads every problem to a multiple of
    1024 and routes 'auto' on that, so 'auto' is decided on the padded
    matrix here too (ops/layout.auto_route), and the route it picks is
    built. A windowed-ELL or butterfly route (and --format window or
    butterfly) builds on the padded matrix, as does what 'auto' falls
    through to when that build refuses the matrix (layout.FALL_THROUGH:
    butterfly, then gather-ELL, as in the JAX package); a DIA or hybrid
    route, and the other formats, on the unpadded one (the port's DIA and
    ELL kernels need no padding). The layout cache keys the CSR the route
    builds from (padded and reordered) with the route and the build
    options (ops/layout.build_operator)."""
    from mpi_bicgstab_tpu_torch.models.problem import (build_problem,
                                                       pad_csr_identity)
    from mpi_bicgstab_tpu_torch.ops.layout import FALL_THROUGH, auto_route
    route = fmt
    if route == "auto":
        route, _ = auto_route(pad_csr_identity(csr, 1024))
    multiple = 1024 if route in FALL_THROUGH else 1
    while True:
        try:
            return build_problem(csr, dtype=dtype, multiple=multiple,
                                 device=dev, format=route,
                                 layout_cache=layout_cache, **kw)
        except ValueError:
            if fmt != "auto" or route not in FALL_THROUGH:
                raise
            route = FALL_THROUGH[route]


def _device_vector(v: np.ndarray, n: int, df: bool, dtype, dev):
    """A host float64 vector zero-padded to n entries, on the device in
    the solve's dtype (a DF pair for df32)."""
    import torch

    from mpi_bicgstab_tpu_torch.ops.precision import df_from_f64
    vp = np.zeros(n)
    vp[: v.size] = v
    return df_from_f64(vp, dev) if df else torch.as_tensor(
        vp, dtype=dtype, device=dev)


def _host_solution(x, n: int, perm, d_invsqrt) -> np.ndarray:
    """A solution ([n_pad] or [k, n_pad], tensor or DF pair) as host
    float64 in the original ordering and scale: the first n entries,
    unscaled (x = D^-1/2 y), unpermuted."""
    from mpi_bicgstab_tpu_torch.ops.precision import df_to_f64, is_df
    from mpi_bicgstab_tpu_torch.ops.reorder import unpermute_vector
    from mpi_bicgstab_tpu_torch.ops.scale import unscale_solution
    X = df_to_f64(x) if is_df(x) else x.double().cpu().numpy()
    X = X[..., :n]
    if d_invsqrt is not None:
        X = unscale_solution(X, d_invsqrt)
    if perm is not None:
        X = unpermute_vector(X.T, perm).T
    return X


def _ready(dev) -> None:
    """Build the kernels and drain the card before a timed solve (the
    build is set-up, not solve time)."""
    if dev.type == "cuda":
        import torch

        from mpi_bicgstab_tpu_torch.ops import _build
        _build.build_all()
        torch.cuda.synchronize(dev)


def _dump_history(path, res) -> None:
    """--dump-history: the per-iteration relative residuals
    history[:n_iter] (the data behind the reference's
    doc/residual_result.png) as .npy, or as .csv with an iteration
    column."""
    if not path:
        return
    hist = res.history[: int(res.n_iter)].double().cpu().numpy()
    if path.endswith(".csv"):
        np.savetxt(path, np.c_[np.arange(1, hist.size + 1), hist],
                   header="iter,relres", delimiter=",", comments="")
    else:
        np.save(path, hist)


def _check_solve_args(args) -> None:
    """The JAX CLI's refusals of flag combinations (JAX cli.py:210-219,
    313-316,327,390-401), before any work."""
    if args.repeat < 1:
        raise SystemExit("--repeat must be >= 1")
    if args.rhs_batch:
        if args.checkpoint or args.x0 or args.repeat != 1:
            raise SystemExit("--rhs-batch cannot be combined with "
                             "--checkpoint/--x0/--repeat")
        if args.rhs or args.dump_history:
            raise SystemExit("--rhs-batch cannot be combined with --rhs "
                             "or --dump-history (one batch IS the set of "
                             "right-hand sides; per-system histories are "
                             "available via the library API)")
    if args.precond != "none" and (args.x0 or args.checkpoint):
        raise SystemExit("--precond cannot be combined with "
                         "--x0/--checkpoint: the preconditioned solver "
                         "iterates in the transformed space y (x = p(A) "
                         "y), so an x-space warm start does not map")
    if args.checkpoint:
        if args.x0:
            raise SystemExit("--x0 cannot be combined with --checkpoint "
                             "(the checkpoint IS the warm start)")
        if args.repeat != 1:
            raise SystemExit("--repeat cannot be combined with "
                             "--checkpoint (segmented timing is not "
                             "comparable); drop one of them")
        if args.dump_history:
            raise SystemExit("--dump-history under --checkpoint would "
                             "cover only the final segment (scaled to its "
                             "own r0, not ||b||); run without --checkpoint "
                             "to record the full curve")
        if args.checkpoint_every < 1:
            raise SystemExit("--checkpoint-every must be >= 1")


def _checkpoint_meta(args, n_state: int, csr, b_user) -> dict:
    """The checkpoint's resume guard, as the JAX CLI writes it: rhs,
    scale and reorder change the linear system, so a checkpoint written
    under other settings refuses to resume rather than reuse a foreign
    cum_rel."""
    import hashlib
    b_hash = (hashlib.sha256(np.ascontiguousarray(b_user)).hexdigest()[:16]
              if b_user is not None else "A*ones")
    return {"n": int(n_state), "nnz": int(csr.nnz), "matrix": args.matrix,
            "dtype": args.dtype, "rhs": b_hash, "scale": args.scale,
            "reorder": args.reorder, "method": args.method}


def run_solve(args):
    """The `solve` command without its printing: returns (report, result)
    where report holds the fields the JAX package's `solve` prints, the
    device layout's name and setup_s (the host seconds from the loaded
    matrix to the device problem: reorder, scaling, the route and the
    layout's build or its load from --layout-cache); with --rhs-batch the
    fields of the JAX package's batched solve, and the batched result.
    The solve runs once untimed, then --repeat times timed
    (total_time_s is their mean), as in the JAX CLI. With --checkpoint
    it runs in segments (utils/checkpoint.solve_with_checkpoints) and
    final_relres is the residual relative to the original ||b||; when
    the checkpoint alone satisfies the run, the report is the JAX CLI's
    short one and the result None."""
    import torch

    from mpi_bicgstab_tpu_torch.api import solve
    from mpi_bicgstab_tpu_torch.ops.reorder import (maybe_reorder,
                                                    permute_vector)
    from mpi_bicgstab_tpu_torch.ops.scale import jacobi_scale, scale_rhs
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
    from mpi_bicgstab_tpu_torch.utils.device import resolve_device

    _check_solve_args(args)
    dev = resolve_device(args.device)
    df = args.dtype == "df32"
    # "df32" builds DF pairs; its config dtype is float32 (canon_dtype)
    dtype = args.dtype if df else getattr(torch, args.dtype)
    csr, io_time = _load_matrix(args.matrix)
    t_set = time.perf_counter()
    csr, perm = maybe_reorder(csr, args.reorder)
    cfg = SolverConfig(tol=args.tol, max_iter=args.max_iter, krr=args.krr,
                       nrr=args.nrr, dtype=dtype, restarts=args.restarts,
                       out_iter=args.verbose_every)
    # a user b in the original row order, permuted with the matrix:
    # (P A P^T)(P x) = P b
    b_user = _load_rhs(args.rhs, csr.nrows) if args.rhs else None
    if b_user is not None and perm is not None:
        b_user = permute_vector(b_user, perm)
    d_invsqrt = None
    if args.scale == "jacobi":
        csr, d_invsqrt = jacobi_scale(csr)
        if b_user is not None:
            b_user = scale_rhs(b_user, d_invsqrt)
    prec = _precond(args.precond, csr)   # bounds of the final operator
    x0_host = None
    if args.x0:
        x0_host = _load_rhs(args.x0, csr.nrows, flag="--x0")
        if perm is not None:
            x0_host = permute_vector(x0_host, perm)
        if d_invsqrt is not None:
            x0_host = x0_host / d_invsqrt    # y = D^1/2 x
    if args.devices > 1:
        return _run_solve_dist(args, csr, dtype, cfg, b_user, x0_host, prec,
                               perm, d_invsqrt, io_time, t_set)
    prob = _build_problem(csr, dtype, dev, args.format, args.layout_cache)
    if args.rhs_batch:
        return _solve_rhs_batch(args, csr, prob, cfg, io_time, prec, perm,
                                d_invsqrt)
    b = prob.b if b_user is None else _device_vector(b_user, prob.n, df,
                                                     dtype, dev)
    x0 = None if x0_host is None else _device_vector(x0_host, prob.n, df,
                                                     dtype, dev)
    setup = time.perf_counter() - t_set
    _ready(dev)
    cum_rel = None
    if args.checkpoint:
        from mpi_bicgstab_tpu_torch.utils.checkpoint import \
            solve_with_checkpoints

        def run_once(x0_seg, budget, tol_seg):
            x0_dev = None if x0_seg is None else _device_vector(
                x0_seg, prob.n, df, dtype, dev)
            return solve(prob.A, b, x0=x0_dev, method=args.method,
                         cfg=cfg.replace(max_iter=budget, tol=tol_seg))

        t0 = time.perf_counter()
        res, done, cum_rel = solve_with_checkpoints(
            run_once, args.checkpoint, segment_iters=args.checkpoint_every,
            max_iter=args.max_iter,
            meta=_checkpoint_meta(args, prob.n, csr, b_user), tol=args.tol)
        total = time.perf_counter() - t0
        if res is None:
            return {"checkpoint": args.checkpoint, "total_iter": done,
                    "final_relres": cum_rel, "converged": cum_rel <= args.tol,
                    "note": "run already complete in checkpoint"}, None
    else:
        res, total = _timed(args.repeat, lambda: solve(
            prob.A, b, x0=x0, method=args.method, cfg=cfg, precond=prec))
        done = res.n_iter
    return _solve_report(args, res, done, total, cum_rel, csr, perm,
                         d_invsqrt, prec, io_time, setup, dev,
                         type(prob.A).__name__), res


def _timed(repeat: int, run):
    """(result, mean seconds): run() once untimed, then `repeat` times
    timed, each waiting for the device (the JAX CLI's --repeat)."""
    def once():
        r = run()
        bool(r.converged)                       # waits for the device
        return r

    res = once()                                # the untimed first run
    t0 = time.perf_counter()
    for _ in range(repeat):
        res = once()
    return res, (time.perf_counter() - t0) / repeat


def _solve_report(args, res, done, total, cum_rel, csr, perm, d_invsqrt,
                  prec, io_time, setup, dev, layout) -> dict:
    """Write --dump-history / --write-solution and return the report."""
    _dump_history(args.dump_history, res)
    if args.write_solution:
        np.save(args.write_solution,
                _host_solution(res.x, csr.nrows, perm, d_invsqrt))
    if prec is None and done >= 1000:
        print(f"hint: this solve took {done} iterations; Chebyshev "
              f"preconditioning (--precond cheby:8) typically cuts "
              f"slow-converging systems ~8-10x for the same SpMV work "
              f"(ops/cheby.py)", file=sys.stderr)
    return {
        "method": args.method,
        "matrix": args.matrix,
        "n": csr.nrows,
        "nnz": csr.nnz,
        "devices": args.devices,
        "device": str(dev),
        "layout": layout,
        "reordered": perm is not None,
        "scaled": d_invsqrt is not None,
        "precond": (f"cheby:{prec.degree}:{prec.lo}:{prec.hi}"
                    if prec is not None else "none"),
        "io_time_s": round(io_time, 6),
        "setup_s": round(setup, 6),
        "total_iter": done,
        "final_relres": (cum_rel if cum_rel is not None
                         else float(res.final_relres)),
        # recursive vs TRUE residual at exit: `converged` is gated on the
        # latter (solvers/base.SolveResult)
        "true_relres": float(res.true_relres),
        "converged": bool(res.converged),
        "total_time_s": round(total, 6),
        "avg_time_per_iter_s": round(total / max(done, 1), 9),
    }


def _part_layout(part) -> str:
    """A partition's layouts, e.g. PartitionedMatrix(dia-halo+ell)."""
    kinds = ([f"dia-{part.dia_mode}"] if part.has_dia else []) \
        + (["window"] if part.has_window else []) \
        + (["butterfly"] if part.has_bfly else []) \
        + (["ell"] if part.has_ell else [])
    return f"PartitionedMatrix({'+'.join(kinds)})"


def _run_solve_dist(args, csr, dtype, cfg, b_user, x0_host, prec, perm,
                    d_invsqrt, io_time, t_set):
    """run_solve on this rank of a --devices world: the partition, this
    rank's shard on its device, and solve_distributed (JAX cli.py:337-
    354), in checkpointed segments with --checkpoint; the global x on
    every rank."""
    from mpi_bicgstab_tpu_torch.parallel.driver import (put_partitioned,
                                                        solve_distributed)
    from mpi_bicgstab_tpu_torch.parallel.mesh import make_row_mesh
    from mpi_bicgstab_tpu_torch.parallel.partition import partition_csr
    part = partition_csr(csr, args.devices, dtype=dtype, format=args.format,
                         cache_dir=args.layout_cache)
    mesh = make_row_mesh(args.devices)
    shard = put_partitioned(part, mesh)
    b = b_user if b_user is not None else csr.matvec(np.ones(csr.nrows))
    setup = time.perf_counter() - t_set
    _ready(mesh.device)
    if args.checkpoint:
        # JAX cli.py:337-420: the iterate checkpoint over the distributed
        # runner; x is global on every rank, rank 0 reads and writes the
        # file and broadcasts a resume (utils/checkpoint.py)
        import torch.distributed as dist

        from mpi_bicgstab_tpu_torch.utils.checkpoint import \
            solve_with_checkpoints

        def run_once(x0_seg, budget, tol_seg):
            return solve_distributed(
                shard, b, x0=x0_seg, method=args.method, mesh=mesh,
                cfg=cfg.replace(max_iter=budget, tol=tol_seg),
                halo=args.halo)

        t0 = time.perf_counter()
        res, done, cum_rel = solve_with_checkpoints(
            run_once, args.checkpoint, segment_iters=args.checkpoint_every,
            max_iter=args.max_iter,
            meta=_checkpoint_meta(args, part.n_global, csr, b_user),
            tol=args.tol, group=dist.group.WORLD)
        total = time.perf_counter() - t0
        if res is None:
            return {"checkpoint": args.checkpoint, "total_iter": done,
                    "final_relres": cum_rel, "converged": cum_rel <= args.tol,
                    "note": "run already complete in checkpoint"}, None
    else:
        res, total = _timed(args.repeat, lambda: solve_distributed(
            shard, b, x0=x0_host, method=args.method, cfg=cfg, mesh=mesh,
            halo=args.halo, precond=prec))
        done, cum_rel = res.n_iter, None
    return _solve_report(args, res, done, total, cum_rel, csr, perm,
                         d_invsqrt, prec, io_time, setup, mesh.device,
                         _part_layout(part)), res


def _precond(spec: str, csr):
    """The --precond spec as a ChebyPrecond with its bounds resolved from
    the host CSR (JAX cli.py:307-312), or None; a bad spec exits with the
    parser's message."""
    from mpi_bicgstab_tpu_torch.ops.cheby import ChebyPrecond
    try:
        prec = ChebyPrecond.parse(spec)
        return prec.resolve(csr) if prec is not None else None
    except ValueError as e:
        raise SystemExit(f"--precond {spec}: {e}") from None


def _solve_rhs_batch(args, csr, prob, cfg, io_time, prec, perm,
                     d_invsqrt):
    """--rhs-batch: every row of a [k, n] .npy solved as a right-hand side
    in one batched solve (api.solve_batched); the rows are permuted and
    scaled with the matrix, the solutions mapped back. Returns (report,
    result), the report with the keys the JAX package's batched solve
    prints."""
    import torch

    from mpi_bicgstab_tpu_torch.api import solve_batched
    from mpi_bicgstab_tpu_torch.ops.precision import df_from_f64
    B = np.load(args.rhs_batch)
    if B.ndim != 2 or B.shape[1] != csr.nrows:
        raise SystemExit(f"--rhs-batch: expected [k, {csr.nrows}], "
                         f"got {B.shape}")
    B = np.asarray(B, np.float64)
    if perm is not None:
        B = B[:, perm]
    if d_invsqrt is not None:
        B = B * d_invsqrt
    Bp = np.zeros((B.shape[0], prob.n))
    Bp[:, : csr.nrows] = B
    dev = prob.A.device
    B_dev = df_from_f64(Bp, dev) if args.dtype == "df32" else \
        torch.as_tensor(Bp, dtype=cfg.dtype, device=dev)
    _ready(dev)
    t0 = time.perf_counter()
    res = solve_batched(prob.A, B_dev, method=args.method, cfg=cfg,
                        precond=prec)
    conv = res.converged.cpu().numpy()      # waits for the device
    wall = time.perf_counter() - t0
    if args.write_solution:
        np.save(args.write_solution,
                _host_solution(res.x, csr.nrows, perm, d_invsqrt))
    report = {
        "method": args.method,
        "matrix": args.matrix,
        "n": csr.nrows,
        "batch": int(res.n_iter.shape[0]),
        "io_time_s": round(io_time, 6),
        "n_iter": res.n_iter.tolist(),
        "converged": conv.tolist(),
        "max_true_relres": float(res.true_relres.max()),
        "total_time_s": round(wall, 6),
    }
    return report, res


def _print_solve(args, report: dict) -> int:
    if args.json and "setup_s" in report:
        # one solve's report: the JAX package's keys (the batched and the
        # checkpoint-complete reports have the JAX keys already)
        report = {k: report[k] for k in SOLVE_JSON_KEYS}
    _report(report, args.json)
    conv = report["converged"]
    return 0 if (all(conv) if isinstance(conv, list) else conv) else 2


def _spawn(fn, args, ranks: int) -> int:
    """fn(args) on `ranks` ranks of a fresh world (parallel/launch.py:
    gloo for --device cpu, NCCL on the card, one card per rank); rank 0
    prints. Returns rank 0's exit code."""
    import torch

    from mpi_bicgstab_tpu_torch.parallel import launch
    from mpi_bicgstab_tpu_torch.utils.device import resolve_device
    dev = resolve_device(args.device)
    if dev.type == "cuda" and ranks > torch.cuda.device_count():
        raise SystemExit(f"--devices: requested {ranks} devices, only "
                         f"{torch.cuda.device_count()} CUDA device(s) "
                         f"present")
    return launch.run(fn, ranks, args, device=dev.type)


def _rank_args(args):
    """(args, context) of this rank: rank 0 prints and writes the files;
    the others compute with their output discarded."""
    import contextlib
    import io

    import torch.distributed as dist
    if dist.get_rank() == 0:
        return args, contextlib.nullcontext()
    quiet = argparse.Namespace(**vars(args))
    quiet.write_solution = quiet.dump_history = None
    return quiet, contextlib.redirect_stdout(io.StringIO())


def solve_rank(args) -> int:
    """`solve --devices N` on one rank (parallel/launch.run's task)."""
    args, ctx = _rank_args(args)
    with ctx:
        code = _print_solve(args, run_solve(args)[0])
        sys.stdout.flush()
    return code


def _check_devices_args(args) -> None:
    if args.devices < 1:
        raise SystemExit("--devices must be >= 1")
    if args.devices > 1 and getattr(args, "rhs_batch", None):
        raise SystemExit("--rhs-batch is single-device (use separate runs "
                         "or shard the batch across processes)")


def cmd_solve(args) -> int:
    _check_devices_args(args)
    if args.devices > 1:
        _check_solve_args(args)
        return _spawn(solve_rank, args, args.devices)
    report, _ = run_solve(args)
    return _print_solve(args, report)


def _ladder(args, S: int):
    """(sigma, seed) of one ladder length: main_shifted.c:95-100,
    sigma_i = (i + 1) sigma_max / len, or, for --sigma-len-sweep,
    main_seed_diff.c:15-17, sigma_i = 0.01 + i sigma_max / len with the
    seed clamped into the ladder. The direct mode refuses a seed outside
    the ladder, the default 255 (main_shifted.c:14) included, as the JAX
    CLI does."""
    if args.sigma_len_sweep:
        return (0.01 + np.arange(S) * (args.sigma_max / S),
                min(args.seed, S - 1))
    if not 0 <= args.seed < S:
        raise SystemExit(f"--seed {args.seed} out of range for --sigma-len "
                         f"{S} (the sweep mode clamps; the direct mode "
                         f"wants an explicit in-range seed)")
    return (np.arange(S) + 1) * (args.sigma_max / S), args.seed


def _check_shifted_args(args) -> None:
    if args.x0:
        raise SystemExit("--x0 is not valid for the shifted family: the "
                         "single-Krylov-sequence recurrences require "
                         "x0 = 0 for every shift")
    if args.checkpoint:
        if args.method != "shifted_lopbicg_switching":
            raise SystemExit("--checkpoint is the seed-switching solver's "
                             "full-carry mechanism; use --method "
                             "shifted_lopbicg_switching")
        if args.sigma_len_sweep or args.repeat != 1:
            raise SystemExit("--checkpoint cannot be combined with "
                             "--sigma-len-sweep or --repeat")
        if args.checkpoint_every < 1:
            raise SystemExit("--checkpoint-every must be >= 1")
    if args.repeat < 1:
        raise SystemExit("--repeat must be >= 1")
    if args.devices < 1:
        raise SystemExit("--devices must be >= 1")
    if args.checkpoint and args.devices > 1:
        raise SystemExit("--checkpoint is single-device for the shifted "
                         "family (the carry is saved unsharded)")
    if args.sigma_devices < 1:
        raise SystemExit("--sigma-devices must be >= 1")
    if args.sigma_devices > 1 and args.devices < 2:
        raise SystemExit("--sigma-devices shards the ladder over a 2-D "
                         "(rows x sigma) grid; it requires the distributed "
                         "path (--devices > 1)")
    for S in _sweep(args):
        if S % args.sigma_devices:
            raise SystemExit(f"--sigma-len {S} not divisible by "
                             f"--sigma-devices {args.sigma_devices}")


def _sweep(args) -> list:
    return ([int(v) for v in args.sigma_len_sweep.split(",")]
            if args.sigma_len_sweep else [args.sigma_len])


def _shifted_dist(args, csr, dtype):
    """(runner, refine) of this rank of a --devices [x --sigma-devices]
    world (JAX cli.py:563-573,627-631): the partition once, this rank's
    shard on its device; runner(b, sigma, seed, cfg) solves over the
    grid, refine(b, sigma, x_set, cfg) over the rows (None on a rank
    beyond them)."""
    from mpi_bicgstab_tpu_torch.parallel.driver import (
        put_partitioned, refine_shifted_distributed,
        solve_shifted_distributed)
    from mpi_bicgstab_tpu_torch.parallel.mesh import (make_grid_mesh,
                                                      make_row_mesh)
    from mpi_bicgstab_tpu_torch.parallel.partition import partition_csr
    part = partition_csr(csr, args.devices, dtype=dtype, format=args.format,
                         cache_dir=args.layout_cache)
    G = args.sigma_devices
    mesh = make_grid_mesh(args.devices, G) if G > 1 \
        else make_row_mesh(args.devices)
    shard = put_partitioned(part, mesh)

    def runner(b, sigma, seed, cfg):
        return solve_shifted_distributed(
            shard, b, sigma, seed=seed, method=args.method, cfg=cfg,
            mesh=mesh, halo=args.halo, sigma_devices=G)

    def refine(b, sigma, x_set, cfg):
        return refine_shifted_distributed(part, b, sigma, x_set, cfg,
                                          halo=args.halo)
    return runner, refine, mesh.device


def run_solve_shifted(args, report=None):
    """The `solve-shifted` command without its exit code: one solve per
    ladder length (one, or each of --sigma-len-sweep), each row's payload
    (the keys the JAX package's solve-shifted prints) handed to
    report(payload) as it is ready. Returns (payloads, the last
    ShiftedResult)."""
    import dataclasses
    import hashlib

    import torch

    from mpi_bicgstab_tpu_torch.api import (refine_shifted_solutions,
                                            solve_shifted,
                                            solve_shifted_checkpointed)
    from mpi_bicgstab_tpu_torch.ops.reorder import (maybe_reorder,
                                                    permute_vector)
    from mpi_bicgstab_tpu_torch.utils.config import (ShiftedConfig,
                                                     SolverConfig)
    from mpi_bicgstab_tpu_torch.utils.device import resolve_device

    _check_shifted_args(args)
    dev = resolve_device(args.device)
    df = args.dtype == "df32"
    dtype = args.dtype if df else getattr(torch, args.dtype)
    csr, io_time = _load_matrix(args.matrix)
    csr, perm = maybe_reorder(csr, args.reorder)
    n = csr.nrows
    b_user = _load_rhs(args.rhs, n) if args.rhs else None
    if b_user is not None and perm is not None:
        b_user = permute_vector(b_user, perm)
    tol = args.tol if args.tol is not None else 1e-12
    if dev.type == "cuda":
        from mpi_bicgstab_tpu_torch.ops import _build
        _build.build_all()    # the kernel build is set-up, not solve time
    dist = _shifted_dist(args, csr, dtype) if args.devices > 1 else None
    rows, res = [], None
    for S in _sweep(args):
        sigma, seed = _ladder(args, S)
        cfg = ShiftedConfig(tol=tol, max_iter=args.max_iter, dtype=dtype,
                            out_iter=args.verbose_every,
                            verbose_switch=args.verbose_every > 0)
        # default rhs: b = (A + sigma_seed I) ones (main_shifted.c:109-114)
        b_host = b_user if b_user is not None else \
            csr.matvec(np.ones(n)) + sigma[seed] * np.ones(n)
        if dist is not None:
            run_dist, refine_dist, dev = dist
        else:
            prob = _build_problem(csr, dtype, dev, args.format,
                                  args.layout_cache,
                                  sigma_seed=float(sigma[seed]))
            b = prob.b if b_user is None else _device_vector(
                b_user, prob.n, df, dtype, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if args.checkpoint:
            meta = {"n": n, "nnz": int(csr.nnz), "matrix": args.matrix,
                    "dtype": args.dtype, "sigma_len": S, "seed": int(seed),
                    "sigma_max": float(args.sigma_max), "tol": float(tol),
                    "reorder": args.reorder,
                    "rhs": hashlib.sha256(np.ascontiguousarray(
                        b_host, np.float64)).hexdigest()[:16]}
            t0 = time.perf_counter()
            res, _ = solve_shifted_checkpointed(
                prob.A, b, sigma, seed=seed, cfg=cfg, path=args.checkpoint,
                segment_iters=args.checkpoint_every, meta=meta)
            float(res.final_relres)             # waits for the device
            total = time.perf_counter() - t0
        else:
            def run_once():
                if dist is not None:
                    r = run_dist(b_host, sigma, seed, cfg)
                else:
                    r = solve_shifted(prob.A, b, sigma, seed=seed,
                                      method=args.method, cfg=cfg)
                float(r.final_relres)           # waits for the device
                return r

            res = run_once()                    # the untimed first run
            t0 = time.perf_counter()
            for _ in range(args.repeat):
                res = run_once()
            total = (time.perf_counter() - t0) / args.repeat
        iters = max(res.n_iter, 1)
        refine_info = {}
        if args.refine:
            rcfg = SolverConfig(tol=tol, max_iter=args.max_iter,
                                dtype=dtype)
            out = refine_dist(b_host, sigma, res.x_set, rcfg) \
                if dist is not None else refine_shifted_solutions(
                    prob.A, b, sigma, res.x_set, rcfg)
            if out is not None:     # None: a rank beyond the rows
                x2, rk, rres = out
                res = dataclasses.replace(res, x_set=x2)
                refine_info = {"refine_iters": int(rk),
                               "max_true_relres_after_refine":
                                   float(rres.max())}
        payload = {
            "method": args.method,
            "matrix": args.matrix,
            "n": n,
            "sigma_len": S,
            "seed": int(seed),
            "final_seed": int(res.final_seed),
            "devices": args.devices,
            "sigma_devices": args.sigma_devices,
            "io_time_s": round(io_time, 6),
            "total_iter": int(res.n_iter),
            "final_relres": float(res.final_relres),
            # the TRUE seed-system residual at exit (one extra SpMV): the
            # decoupling detector for the whole estimated ladder
            "seed_true_relres": float(res.true_relres),
            "max_shift_relres": float(res.shift_relres.max()),
            "all_converged": bool(res.stop_flags.all()),
            "total_time_s": round(total, 6),
            "avg_time_per_iter_s": round(total / iters, 9),
            **refine_info,
        }
        _dump_history(args.dump_history, res)
        if args.write_solution:
            np.save(args.write_solution,
                    _host_solution(res.x_set, n, perm, None))
        if args.check_error:
            xs = _host_solution(res.x_set, n, None, None)   # permuted
            # test_shifted.c:129-154: the true relative error per shift
            nb = np.linalg.norm(b_host)
            payload["max_true_rel_error"] = max(
                float(np.linalg.norm(csr.matvec(xs[j]) + sigma[j] * xs[j]
                                     - b_host) / nb)
                for j in range(S))
        rows.append(payload)
        if report is not None:
            report(payload)
    return rows, res


def cmd_solve_shifted(args) -> int:
    if args.devices > 1:
        _check_shifted_args(args)
        return _spawn(solve_shifted_rank, args,
                      args.devices * args.sigma_devices)
    rows, _ = run_solve_shifted(
        args, report=lambda payload: _report(payload, args.json))
    return 0 if all(r["all_converged"] for r in rows) else 2


def solve_shifted_rank(args) -> int:
    """`solve-shifted --devices N` on one rank (parallel/launch.run's
    task)."""
    args, ctx = _rank_args(args)
    with ctx:
        rows, _ = run_solve_shifted(
            args, report=lambda payload: _report(payload, args.json))
        sys.stdout.flush()
    return 0 if all(r["all_converged"] for r in rows) else 2


def run_info(device="cuda") -> dict:
    """The `info` census (JAX cli.py:694-755): what runs HERE. The card
    (name, count, power limit), the torch and CUDA versions and nvcc;
    which CUDA kernels the routes take per method, dtype and layout (the
    port has no opt-outs: every route below engages wherever its layout
    and dtype hold); the layouts and the preconditioners. With --device
    cpu every kernel's plain PyTorch twin runs in its place."""
    import torch

    from mpi_bicgstab_tpu_torch import api
    from mpi_bicgstab_tpu_torch.benchmarks.runner import card_census
    from mpi_bicgstab_tpu_torch.ops import _build
    from mpi_bicgstab_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    card = card_census()
    try:
        nvcc = _build.nvcc_path()
    except RuntimeError:
        nvcc = None
    fused = {m: ["f32"] * (m in api.FUSED) + ["df32"] * (m in api.FUSED_DF)
             for m in api.METHODS}
    return {
        "process_count": 1,
        "device": str(dev),
        "device_count": card["device_count"],
        "devices": [torch.cuda.get_device_name(i)
                    for i in range(card["device_count"])],
        "power_limit": card["power_limit"],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": nvcc,
        "kernels": ("CUDA kernels (csrc/*.cu, built into build/kernels/)"
                    if dev.type == "cuda" else
                    "plain PyTorch twins of the CUDA kernels (CPU)"),
        # fused iteration routes on a square DIA operator (api.FUSED,
        # api.FUSED_DF); every other case runs the unfused solver over
        # the layout's SpMV
        "fused_kernels": {
            **fused,
            "pipe_bicgstab (df32, other layouts or cheby)":
                ["df32 fused bodies"],
            "shifted_lopbicg_switching":
                (["f32 blocked"] if dev.type == "cuda" else [])
                + ["df32 fused shift update"],
            "cheby_chain": ["f32", "df32"],
            "batched bicgstab (k <= 8)": ["f32"],
        },
        "spmv_kernels": {"dia": ["f32", "f64", "df32"],
                         "window": ["f32", "f64", "df32"],
                         "butterfly": ["f32", "f64", "df32"],
                         "ell": []},
        "layouts": ["dia", "hybrid", "ell", "window_ell", "butterfly"],
        "preconditioners": ["cheby (chain kernel on DIA, f32 + df32)",
                            "jacobi scaling (--scale)"],
    }


def cmd_info(args) -> int:
    print(json.dumps(run_info(args.device), indent=2))
    return 0


def _host_x(x) -> np.ndarray:
    from mpi_bicgstab_tpu_torch.ops.precision import df_to_f64, is_df
    return df_to_f64(x) if is_df(x) else x.double().cpu().numpy()


def _selftest_solve(method: str, gen: str = "banded"):
    def check(dtype, tol, dev):
        from mpi_bicgstab_tpu_torch.api import solve
        from mpi_bicgstab_tpu_torch.models import generators as G
        from mpi_bicgstab_tpu_torch.models.problem import build_problem
        from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
        csr = (G.skew_banded(2048) if gen == "skew" else
               G.banded_random(2048, [1, -1, 13, -13], seed=0))
        prob = build_problem(csr, dtype=dtype, multiple=1024, device=dev)
        r = solve(prob.A, prob.b, method=method,
                  cfg=SolverConfig(tol=tol, max_iter=4000, dtype=dtype))
        err = float(np.abs(prob.unpermute(_host_x(r.x))[: csr.nrows]
                           - 1.0).max())
        return bool(r.converged), (f"true={float(r.true_relres):.1e} "
                                   f"|x-1|={err:.1e}")
    return check


def _selftest_cheby(dtype, tol, dev):
    from mpi_bicgstab_tpu_torch.api import solve
    from mpi_bicgstab_tpu_torch.models import generators as G
    from mpi_bicgstab_tpu_torch.models.problem import build_problem
    from mpi_bicgstab_tpu_torch.ops.cheby import ChebyPrecond, estimate_bounds
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
    csr = G.transport_hard(4096)
    prob = build_problem(csr, dtype=dtype, multiple=1024, device=dev)
    lo, hi = estimate_bounds(csr)
    r = solve(prob.A, prob.b, method="bicgstab",
              cfg=SolverConfig(tol=max(tol, 1e-5), max_iter=4000,
                               dtype=dtype),
              precond=ChebyPrecond(degree=4, lo=lo, hi=hi))
    return bool(r.converged), f"iters={r.n_iter}"


def _selftest_df32(dtype, tol, dev):
    """df32 at a tolerance float32 cannot reach, whatever --dtype says."""
    return _selftest_solve("bicgstab")("df32", 1e-11, dev)


def _selftest_layout(fmt: str, gen):
    def check(dtype, tol, dev):
        import torch

        from mpi_bicgstab_tpu_torch.ops.layout import build_operator, spmv
        from mpi_bicgstab_tpu_torch.ops.precision import df_from_f64
        csr = gen()
        op = build_operator(csr, format=fmt, dtype=dtype, device=dev)
        x_h = np.random.default_rng(0).standard_normal(csr.nrows)
        x = df_from_f64(x_h, dev) if dtype == "df32" else torch.as_tensor(
            x_h, dtype=dtype, device=dev)
        y = _host_x(spmv(op, x))
        ref = csr.matvec(x_h)
        rel = float(np.abs(y[: csr.nrows] - ref).max() / np.abs(ref).max())
        return rel < 1e-4, f"layout={type(op).__name__} rel={rel:.1e}"
    return check


def _selftest_shifted(dtype, tol, dev):
    from mpi_bicgstab_tpu_torch.api import solve_shifted
    from mpi_bicgstab_tpu_torch.models import generators as G
    from mpi_bicgstab_tpu_torch.models.problem import build_problem
    from mpi_bicgstab_tpu_torch.utils.config import ShiftedConfig
    csr = G.banded_random(2048, [1, -1, 13, -13], seed=0)
    sigma = np.array([0.0, 0.01, 0.05, 0.2])
    prob = build_problem(csr, dtype=dtype, multiple=1024, device=dev,
                         sigma_seed=float(sigma[2]))
    r = solve_shifted(prob.A, prob.b, sigma, seed=2,
                      method="shifted_lopbicg_switching",
                      cfg=ShiftedConfig(tol=tol, max_iter=4000, dtype=dtype))
    return bool(r.stop_flags.all()), (f"iters={r.n_iter} seed_true="
                                      f"{float(r.true_relres):.1e}")


def _gen(name: str, *a, **kw):
    def make():
        from mpi_bicgstab_tpu_torch.models import generators as G
        return getattr(G, name)(*a, **kw)
    return make


# the selftest's checks (JAX cli.py:757-947): name -> check(dtype, tol,
# device) returning (ok, detail); each solves or multiplies through the
# normal entry points, so on the card through the kernels
SELFTEST = {
    **{f"solve/{m}": _selftest_solve(m)
       for m in ("bicgstab", "ca_bicgstab", "pipe_bicgstab",
                 "pipe_bicgstab_rr")},
    "solve/bicgstab_l2 (skew spectrum)": _selftest_solve("bicgstab_l2",
                                                         gen="skew"),
    "solve/bicgstab+cheby4": _selftest_cheby,
    "precision/df32 tight tolerance": _selftest_df32,
    "layout/dia": _selftest_layout(
        "dia", _gen("banded_random", 2048, [1, -1, 9, -9], seed=0)),
    "layout/window": _selftest_layout("window",
                                      _gen("clustered_random", 2048)),
    "layout/butterfly": _selftest_layout(
        "butterfly", _gen("random_diag_dominant", 2048, nnz_per_row=6,
                          seed=0)),
    "layout/ell": _selftest_layout(
        "ell", _gen("random_diag_dominant", 1024, nnz_per_row=6, seed=1)),
    "shifted/switching (4 shifts)": _selftest_shifted,
}


def selftest_tol(dtype: str) -> float:
    """The checks' tolerance: one the float32 true-residual floor meets
    for float32, 1e-10 otherwise (as in the JAX CLI off the TPU)."""
    return 1e-5 if dtype == "float32" else 1e-10


def run_selftest_check(name: str, dtype: str, device) -> tuple:
    """(ok, detail, seconds) of one SELFTEST check; an exception is a
    failure whose detail is the error."""
    import torch

    from mpi_bicgstab_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    dt = dtype if dtype == "df32" else getattr(torch, dtype)
    t0 = time.perf_counter()
    try:
        ok, detail = SELFTEST[name](dt, selftest_tol(dtype), dev)
    except Exception as e:  # noqa: BLE001 — report it, test the rest
        ok, detail = False, f"{type(e).__name__}: {e}"
    return ok, detail, time.perf_counter() - t0


def _selftest_dist(pool, n: int, dtype, tol):
    """The distributed checks (JAX cli.py:864-905) on a pool of n ranks:
    name -> check() returning (ok, detail)."""
    from mpi_bicgstab_tpu_torch.models import generators as G
    from mpi_bicgstab_tpu_torch.parallel import driver
    from mpi_bicgstab_tpu_torch.parallel.partition import partition_csr
    from mpi_bicgstab_tpu_torch.utils.config import (ShiftedConfig,
                                                     SolverConfig)

    def dist():
        csr = G.banded_random(2048, [1, -1, 13, -13], seed=0)
        r = pool.run(driver.solve_distributed,
                     partition_csr(csr, n, dtype=dtype),
                     csr.matvec(np.ones(csr.nrows)),
                     cfg=SolverConfig(tol=tol, max_iter=4000, dtype=dtype))
        return bool(r.converged), f"devices={n} iters={r.n_iter}"

    def sigma_grid():
        """The rows x sigma grid must reproduce the rows-only trajectory
        bit for bit (parallel/sigma.py)."""
        csr = G.banded_random(1024, [1, -1, 9, -9], seed=0)
        sigma = np.array([0.0, 0.01, 0.05, 0.2])
        b = csr.matvec(np.ones(csr.nrows)) + sigma[2]
        part = partition_csr(csr, n // 2, dtype=dtype)
        kw = dict(seed=2, method="shifted_lopbicg_switching",
                  cfg=ShiftedConfig(tol=tol, max_iter=2000, dtype=dtype))
        r1 = pool.run(driver.solve_shifted_distributed, part, b, sigma, **kw)
        r2 = pool.run(driver.solve_shifted_distributed, part, b, sigma,
                      sigma_devices=2, **kw)
        same = (int(r1.n_iter) == int(r2.n_iter)
                and float(r1.final_relres) == float(r2.final_relres))
        return same, (f"iters {int(r1.n_iter)}=={int(r2.n_iter)}, "
                      f"relres equal={same}")

    checks = {f"distributed/bicgstab x{n}": dist}
    if n >= 4 and n % 2 == 0:
        checks[f"distributed/sigma-grid {n // 2}x2"] = sigma_grid
    return checks


def cmd_selftest(args) -> int:
    """Every SELFTEST check in --dtype on --device, each printed PASS or
    FAIL with its seconds, then with --devices N the distributed checks
    over N ranks; exit 2 on any failure. The reference's analogue is
    test_shifted.c built with DISPLAY_ERROR (test_shifted.c:10,129-154)."""
    import torch

    n_fail = n_run = 0

    def say(name, ok, detail, sec):
        nonlocal n_fail, n_run
        n_fail += not ok
        n_run += 1
        print(f"{'PASS' if ok else 'FAIL':4} {name:42} {sec:6.1f}s  "
              f"{detail}", flush=True)

    for name in SELFTEST:
        say(name, *run_selftest_check(name, args.dtype, args.device))
    if args.devices > 1:
        from mpi_bicgstab_tpu_torch.parallel import launch
        from mpi_bicgstab_tpu_torch.utils.device import resolve_device
        dev = resolve_device(args.device)
        if dev.type == "cuda" and args.devices > torch.cuda.device_count():
            raise SystemExit(f"--devices: requested {args.devices} "
                             f"devices, only {torch.cuda.device_count()} "
                             f"CUDA device(s) present")
        dt = args.dtype if args.dtype == "df32" else getattr(torch,
                                                             args.dtype)
        with launch.Pool(args.devices, dev.type) as pool:
            for name, check in _selftest_dist(
                    pool, args.devices, dt, selftest_tol(args.dtype)).items():
                t0 = time.perf_counter()
                try:
                    ok, detail = check()
                except Exception as e:  # noqa: BLE001 — report it
                    ok, detail = False, f"{type(e).__name__}: {e}"
                say(name, ok, detail, time.perf_counter() - t0)
    print(f"\n{n_run - n_fail}/{n_run} passed "
          f"(device={args.device}, dtype={args.dtype})")
    return 2 if n_fail else 0


def cmd_convert(args) -> int:
    from mpi_bicgstab_tpu_torch.ops.sparse import save_csr
    csr, io_time = _load_matrix(args.src)
    t0 = time.perf_counter()
    save_csr(args.dst, csr)
    print(f"{args.src} ({csr.nrows} rows, {csr.nnz} nnz, parsed in "
          f"{io_time:.2f}s) -> {args.dst} "
          f"(written in {time.perf_counter() - t0:.2f}s)")
    return 0


def cmd_bench(args) -> int:
    from mpi_bicgstab_tpu_torch.benchmarks.runner import run_bench
    return run_bench(args)


def cmd_profile(args) -> int:
    from mpi_bicgstab_tpu_torch.benchmarks.sections import run_profile
    return run_profile(args)


def _add_layout(p) -> None:
    p.add_argument("--format", default="auto",
                   choices=["auto", "dia", "hybrid", "ell", "window",
                            "butterfly"],
                   help="device layout (ops/layout.build_operator); "
                        "'auto' routes by structure analysis on the "
                        "matrix padded to a multiple of 1024 (DIA/hybrid, "
                        "else windowed-ELL, else butterfly, else "
                        "gather-ELL), 'window' is windowed-ELL and "
                        "'butterfly' the routed layout for matrices "
                        "without locality (both built padded), 'ell' the "
                        "faithful-to-reference gather layout")
    p.add_argument("--reorder", choices=["none", "rcm", "auto"],
                   default="auto",
                   help="bandwidth-reducing RCM permutation; 'auto' "
                        "reorders only when it moves the matrix onto "
                        "diagonals (ops/reorder.py)")
    p.add_argument("--layout-cache", default=None, metavar="DIR",
                   help="persistent layout cache (utils/opcache.py): a "
                        "repeat solve of the same matrix loads the built "
                        "layout instead of building it on the host (the "
                        "butterfly route, the window build); keyed by the "
                        "matrix's content and every build option; default "
                        "$MBT_LAYOUT_CACHE, '0' or 'off' disables")


def _add_output(p) -> None:
    p.add_argument("--repeat", type=int, default=1,
                   help="after one untimed run, time N runs and report "
                        "their mean (main_repeat.c:109-132)")
    p.add_argument("--json", action="store_true",
                   help="print one JSON line of the JAX package's keys")
    p.add_argument("--dump-history", default=None, metavar="FILE",
                   help="write the per-iteration relative residuals (the "
                        "data behind the reference's "
                        "doc/residual_result.png) as .npy or .csv")


def _add_devices(p) -> None:
    p.add_argument("--devices", type=int, default=1,
                   help="ranks of the row partition; > 1 starts them "
                        "(parallel/launch.py: NCCL on the cards, gloo with "
                        "--device cpu) and takes the distributed path")
    p.add_argument("--halo", choices=["allgather", "ring"],
                   default="allgather",
                   help="how the off-diagonal ELL blocks get the iterate "
                        "(parallel/dist_spmv.py)")


def _add_device(p) -> None:
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to run (default: the card; raises without "
                        "one)")


def build_parser() -> argparse.ArgumentParser:
    from mpi_bicgstab_tpu_torch.api import METHODS

    ap = argparse.ArgumentParser(
        prog="python -m mpi_bicgstab_tpu_torch",
        description="BiCGStab on one NVIDIA GPU (PyTorch + CUDA port of "
                    "mpi_bicgstab_tpu)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("solve", help="solve A x = b (reference main.c)")
    p.add_argument("--matrix", required=True,
                   help=".mtx/.npz path or generator spec (poisson2d:N, "
                        "poisson3d:N, transport-like:N, transport-hard:N, "
                        "banded:N, skew:N, clustered:N, uniform:N)")
    p.add_argument("--method", default="bicgstab", choices=METHODS,
                   help="the classic family (reference main.c:122-141) "
                        "and BiCGStab(l); float32 on a DIA matrix takes "
                        "the method's fused CUDA kernels (BiCGStab(l) "
                        "has none)")
    p.add_argument("--dtype", choices=["float32", "float64", "df32"],
                   default="float64",
                   help="float32 takes the fused CUDA kernels on DIA "
                        "matrices; df32 (double-float pairs, ~48-bit "
                        "significands from float32 arithmetic) takes the "
                        "fused DF kernels with --method bicgstab")
    p.add_argument("--tol", type=float, default=1e-15)
    p.add_argument("--max-iter", type=int, default=1000)
    p.add_argument("--krr", type=int, default=100,
                   help="pipe_bicgstab_rr: replace the residual every "
                        "krr iterations")
    p.add_argument("--nrr", type=int, default=4,
                   help="pipe_bicgstab_rr: at most nrr replacements")
    p.add_argument("--restarts", type=int, default=2,
                   help="refinement restarts when the true-residual gate "
                        "fails after the recurrence hit tol; 0 = the "
                        "reference's one pass")
    p.add_argument("--rhs", default=None, metavar="FILE",
                   help="right-hand side b (.npy or Matrix Market "
                        "vector); default b = A*ones")
    p.add_argument("--rhs-batch", default=None, metavar="FILE.npy",
                   help="solve A x_j = b_j for a BATCH of right-hand "
                        "sides ([k, n] .npy) in one batched run; float32 "
                        "bicgstab on a DIA matrix with k <= 8 streams the "
                        "band once per pass for the whole batch "
                        "(api.solve_batched)")
    p.add_argument("--precond", default="none",
                   help="none | cheby[:D[:LO:HI]]: right Chebyshev "
                        "polynomial preconditioning of degree D (default "
                        "8); bounds default to Gershgorin estimates; on a "
                        "float32 or df32 DIA matrix the chain runs as one "
                        "CUDA kernel (ops/cheby.py)")
    p.add_argument("--write-solution", default=None, metavar="FILE",
                   help="save the solution x (float64, original row "
                        "order and scale) as .npy; with --rhs-batch the "
                        "stacked [k, n] solutions")
    p.add_argument("--x0", default=None, metavar="FILE",
                   help="warm-start iterate (.npy or Matrix Market "
                        "vector, original row order), e.g. a previous "
                        "--write-solution output")
    p.add_argument("--scale", choices=["none", "jacobi"], default="none",
                   help="symmetric Jacobi scaling D^-1/2 A D^-1/2 "
                        "(ops/scale.py); the solution is unscaled")
    p.add_argument("--verbose-every", type=int, default=0, metavar="N",
                   help="print the relative residual every N iterations "
                        "(DISPLAY_RESIDUAL, solver.c:8-9; takes the "
                        "unfused solver); 0 = silent")
    p.add_argument("--checkpoint", default=None, metavar="FILE",
                   help="save the iterate to FILE every --checkpoint-every "
                        "iterations and resume from it when present "
                        "(utils/checkpoint.py; a classic-family restart "
                        "from the iterate is exact)")
    p.add_argument("--checkpoint-every", type=int, default=200)
    _add_devices(p)
    _add_output(p)
    _add_layout(p)
    _add_device(p)
    p.set_defaults(fn=cmd_solve)

    from mpi_bicgstab_tpu_torch.api import _all_shifted_solvers
    p = sub.add_parser("solve-shifted",
                       help="solve (A + sigma_j I) x_j = b for a ladder of "
                            "shifts (reference main_shifted.c)")
    p.add_argument("--matrix", required=True,
                   help=".mtx/.npz path or generator spec (as for solve)")
    p.add_argument("--method", default="shifted_lopbicg_switching",
                   choices=sorted(_all_shifted_solvers()),
                   help="the seed-switching solver (default; the "
                        "reference's flagship) or another shifted method")
    p.add_argument("--dtype", choices=["float32", "float64", "df32"],
                   default="float64",
                   help="df32 runs the seed-switching shift updates "
                        "through the fused DF CUDA kernel; float32 on the "
                        "card through blocked matrix-product updates")
    p.add_argument("--tol", type=float, default=None,
                   help="per-shift relative-residual tolerance "
                        "(default 1e-12)")
    p.add_argument("--max-iter", type=int, default=1000)
    p.add_argument("--sigma-len", type=int, default=512)
    p.add_argument("--sigma-max", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=_SEED,
                   help="seed system's index in the ladder (default "
                        "%(default)s, the reference's; a shorter ladder "
                        "needs an explicit seed)")
    p.add_argument("--sigma-len-sweep", default=None,
                   help="comma list, e.g. 8,32,128,512 (main_seed_diff.c)")
    p.add_argument("--refine", action="store_true",
                   help="after the shifted solve, polish every shift with "
                        "a batched BiCGStab until the TRUE per-shift "
                        "residuals meet --tol (solvers/refine.py)")
    p.add_argument("--check-error", action="store_true",
                   help="compute the true per-shift relative errors on "
                        "the host (test_shifted.c DISPLAY_ERROR)")
    p.add_argument("--checkpoint", default=None, metavar="FILE",
                   help="full-carry checkpoint every --checkpoint-every "
                        "iterations; resume is BIT-identical to an "
                        "uninterrupted solve (shifted_lopbicg_switching; "
                        "utils/checkpoint.py)")
    p.add_argument("--checkpoint-every", type=int, default=200)
    p.add_argument("--rhs", default=None, metavar="FILE",
                   help="right-hand side b (.npy or Matrix Market "
                        "vector); default b = (A + sigma_seed I) ones")
    p.add_argument("--write-solution", default=None, metavar="FILE",
                   help="save the [sigma_len, n] solutions (float64, "
                        "original row order) as .npy")
    p.add_argument("--x0", default=None, metavar="FILE",
                   help="refused: the shifted family starts from x0 = 0")
    _add_devices(p)
    p.add_argument("--sigma-devices", type=int, default=1, metavar="G",
                   help="shard the shift ladder over a second grid axis of "
                        "G ranks (--devices x G ranks as a rows-by-sigma "
                        "grid; requires --devices > 1 and sigma-len "
                        "divisible by G; parallel/sigma.py)")
    _add_output(p)
    p.add_argument("--verbose-every", type=int, default=0, metavar="N",
                   help="print the seed relative residual every N "
                        "iterations, and each seed switch; 0 = silent")
    _add_layout(p)
    _add_device(p)
    p.set_defaults(fn=cmd_solve_shifted)

    p = sub.add_parser("info", help="census of what runs here: the card, "
                                    "the kernel routes, the layouts "
                                    "(main.c:22-60)")
    _add_device(p)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser(
        "selftest",
        help="check every solver family, layout and precision on a small "
             "system against ground truth; exit 0 = all pass (on the card "
             "through the CUDA kernels)")
    p.add_argument("--dtype", choices=["float32", "float64", "df32"],
                   default="float32")
    p.add_argument("--devices", type=int, default=1,
                   help="> 1 adds the distributed checks over that many "
                        "ranks (and the rows x sigma grid for an even "
                        "count >= 4)")
    _add_device(p)
    p.set_defaults(fn=cmd_selftest)

    p = sub.add_parser("profile",
                       help="per-phase section timings (the reference's "
                            "MEASURE_SECTION_TIME mode)")
    p.add_argument("--matrix", default="transport-like:200000")
    p.add_argument("--dtype", choices=["float32", "float64"],
                   default="float32")
    p.add_argument("--devices", type=int, default=1)
    p.add_argument("--sigma-len", type=int, default=0)
    p.add_argument("--iters", type=int, default=60)
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="also write a torch.profiler trace (Chrome JSON) "
                        "of one solve to DIR")
    p.add_argument("--json", action="store_true")
    _add_device(p)
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser(
        "convert",
        help="write a Matrix Market file (or a generator spec) as the "
             "binary CSR container (.npz) for near-instant loads")
    p.add_argument("src", help=".mtx/.mtx.gz path or generator spec")
    p.add_argument("dst", help="output .npz path")
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("bench", help="SpMV and solver-iteration times, one "
                                     "JSON line (on the card by default)")
    p.add_argument("--matrix", default="transport-like:1602112")
    p.add_argument("--dtype", choices=["float32", "float64", "df32"],
                   default="float32")
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--what", default="spmv,iter",
                   help="comma list: spmv, iter, shifted, batched (k = 8 "
                        "right-hand sides against one), cheby (the chain "
                        "kernel against the unfused chain), overlap (the "
                        "distributed solve with its reductions overlapped "
                        "against serialize_comm) and scaling (1, 2, 4, "
                        "... ranks up to --devices)")
    p.add_argument("--devices", type=int, default=1,
                   help="ranks: > 1 (or overlap / scaling) spawns them as "
                        "solve --devices does and times the distributed "
                        "path; rank 0 prints")
    p.add_argument("--method", default=None,
                   help="solver of the iter, shifted and batched sections")
    p.add_argument("--sigma-len", type=int, default=512,
                   help="ladder width of --what shifted "
                        "(main_shifted.c:13)")
    p.add_argument("--seed", type=int, default=_SEED)
    p.add_argument("--shift-block", type=int, default=-1,
                   help="blocked shift-update depth of --what shifted: -1 "
                        "auto, 0 the per-iteration path, > 0 explicit L")
    p.add_argument("--layout-cache", default=None, metavar="DIR",
                   help="persistent layout cache of the benched operators "
                        "(sets MBT_LAYOUT_CACHE; no layout is built inside "
                        "a timed chain)")
    p.add_argument("--json", action="store_true",
                   help="accepted for the JAX CLI's sake: the line is JSON "
                        "always")
    _add_device(p)
    p.set_defaults(fn=cmd_bench)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
