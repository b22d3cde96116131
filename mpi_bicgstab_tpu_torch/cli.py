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
hybrid one on the unpadded matrix; 'ell' takes any matrix); --precond cheby[:D[:LO:HI]]
solves right-preconditioned with a degree-D Chebyshev polynomial, its
bounds estimated from the matrix unless given (ops/cheby.py). The solve
runs on the card unless --device cpu asks for the CPU. It prints the
fields the JAX package's `solve` prints and exits 0 when the solve
converged, 2 when it did not. `solve --rhs-batch B.npy` solves every
row of a [k, n] array as a right-hand side in one batched solve
(api.solve_batched), prints the JAX package's batched fields and exits 0
only when every lane converged. `solve-shifted` (reference
main_shifted.c) solves a ladder of shifted systems with the
seed-switching solver or another shifted method, prints the JAX
package's solve-shifted fields, and exits 0 when every shift converged,
2 otherwise.
"""
from __future__ import annotations

import argparse
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


def _report(payload: dict) -> None:
    for k, v in payload.items():
        print(f"{k:>16s}: {v}")


def _build_problem(args, csr, dtype, dev, **kw):
    """build_problem in the layout --format asks for, padded as the JAX
    CLI would need it: the JAX CLI pads every problem to a multiple of
    1024 and routes 'auto' on that, so 'auto' is decided on the padded
    matrix here too (ops/layout.auto_route), and the route it picks is
    built. A windowed-ELL or butterfly route (and --format window or
    butterfly) builds on the padded matrix, as does what 'auto' falls
    through to when that build refuses the matrix (layout.FALL_THROUGH:
    butterfly, then gather-ELL, as in the JAX package); a DIA or hybrid
    route, and the other formats, on the unpadded one (the port's DIA and
    ELL kernels need no padding)."""
    from mpi_bicgstab_tpu_torch.models.problem import (build_problem,
                                                       pad_csr_identity)
    from mpi_bicgstab_tpu_torch.ops.layout import FALL_THROUGH, auto_route
    fmt = args.format
    if fmt == "auto":
        fmt, _ = auto_route(pad_csr_identity(csr, 1024))
    multiple = 1024 if fmt in FALL_THROUGH else 1
    while True:
        try:
            return build_problem(csr, dtype=dtype, multiple=multiple,
                                 device=dev, format=fmt, **kw)
        except ValueError:
            if args.format != "auto" or fmt not in FALL_THROUGH:
                raise
            fmt = FALL_THROUGH[fmt]


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


def run_solve(args):
    """The `solve` command without its printing: returns (report, result)
    where report holds the fields the JAX package's `solve` prints, the
    device layout's name and setup_s (the host seconds from the loaded
    matrix to the device problem: reorder, scaling, the route and the
    layout's build); with --rhs-batch the fields of the JAX package's
    batched solve, and the batched result."""
    import torch

    from mpi_bicgstab_tpu_torch.api import solve
    from mpi_bicgstab_tpu_torch.ops.reorder import (maybe_reorder,
                                                    permute_vector)
    from mpi_bicgstab_tpu_torch.ops.scale import jacobi_scale, scale_rhs
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
    from mpi_bicgstab_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.rhs_batch and args.rhs:
        raise SystemExit("--rhs-batch cannot be combined with --rhs "
                         "or --dump-history (one batch IS the set of "
                         "right-hand sides; per-system histories are "
                         "available via the library API)")
    if args.rhs_batch and args.x0:
        raise SystemExit("--rhs-batch cannot be combined with --x0")
    df = args.dtype == "df32"
    # "df32" builds DF pairs; its config dtype is float32 (canon_dtype)
    dtype = args.dtype if df else getattr(torch, args.dtype)
    csr, io_time = _load_matrix(args.matrix)
    t_set = time.perf_counter()
    csr, perm = maybe_reorder(csr, args.reorder)
    cfg = SolverConfig(tol=args.tol, max_iter=args.max_iter, krr=args.krr,
                       nrr=args.nrr, dtype=dtype, restarts=args.restarts)
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
    if prec is not None and args.x0:
        raise SystemExit("--precond cannot be combined with --x0: the "
                         "preconditioned solver iterates in the "
                         "transformed space y (x = p(A) y), so an x-space "
                         "warm start does not map")
    x0_host = None
    if args.x0:
        x0_host = _load_rhs(args.x0, csr.nrows, flag="--x0")
        if perm is not None:
            x0_host = permute_vector(x0_host, perm)
        if d_invsqrt is not None:
            x0_host = x0_host / d_invsqrt    # y = D^1/2 x
    prob = _build_problem(args, csr, dtype, dev)
    if args.rhs_batch:
        return _solve_rhs_batch(args, csr, prob, cfg, io_time, prec, perm,
                                d_invsqrt)
    b = prob.b if b_user is None else _device_vector(b_user, prob.n, df,
                                                     dtype, dev)
    x0 = None if x0_host is None else _device_vector(x0_host, prob.n, df,
                                                     dtype, dev)
    setup = time.perf_counter() - t_set
    _ready(dev)
    t0 = time.perf_counter()
    res = solve(prob.A, b, x0=x0, method=args.method, cfg=cfg,
                precond=prec)
    converged = bool(res.converged)      # waits for the device
    total = time.perf_counter() - t0
    done = res.n_iter
    if args.write_solution:
        np.save(args.write_solution,
                _host_solution(res.x, csr.nrows, perm, d_invsqrt))
    if prec is None and done >= 1000:
        print(f"hint: this solve took {done} iterations; Chebyshev "
              f"preconditioning (--precond cheby:8) typically cuts "
              f"slow-converging systems ~8-10x for the same SpMV work "
              f"(ops/cheby.py)", file=sys.stderr)
    report = {
        "method": args.method,
        "matrix": args.matrix,
        "n": csr.nrows,
        "nnz": csr.nnz,
        "devices": 1,
        "device": str(dev),
        "layout": type(prob.A).__name__,
        "reordered": perm is not None,
        "scaled": d_invsqrt is not None,
        "precond": (f"cheby:{prec.degree}:{prec.lo}:{prec.hi}"
                    if prec is not None else "none"),
        "io_time_s": round(io_time, 6),
        "setup_s": round(setup, 6),
        "total_iter": done,
        "final_relres": float(res.final_relres),
        # recursive vs TRUE residual at exit: `converged` is gated on the
        # latter (solvers/base.SolveResult)
        "true_relres": float(res.true_relres),
        "converged": converged,
        "total_time_s": round(total, 6),
        "avg_time_per_iter_s": round(total / max(done, 1), 9),
    }
    return report, res


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


def cmd_solve(args) -> int:
    report, _ = run_solve(args)
    _report(report)
    conv = report["converged"]
    return 0 if (all(conv) if isinstance(conv, list) else conv) else 2


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
    sweep = ([int(v) for v in args.sigma_len_sweep.split(",")]
             if args.sigma_len_sweep else [args.sigma_len])
    rows, res = [], None
    for S in sweep:
        sigma, seed = _ladder(args, S)
        cfg = ShiftedConfig(tol=tol, max_iter=args.max_iter, dtype=dtype,
                            out_iter=args.verbose_every,
                            verbose_switch=args.verbose_every > 0)
        # default rhs: b = (A + sigma_seed I) ones (main_shifted.c:109-114)
        b_host = b_user if b_user is not None else \
            csr.matvec(np.ones(n)) + sigma[seed] * np.ones(n)
        prob = _build_problem(args, csr, dtype, dev,
                              sigma_seed=float(sigma[seed]))
        b = prob.b if b_user is None else _device_vector(b_user, prob.n, df,
                                                         dtype, dev)
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
            t0 = time.perf_counter()
            for _ in range(args.repeat):
                res = solve_shifted(prob.A, b, sigma, seed=seed,
                                    method=args.method, cfg=cfg)
                float(res.final_relres)         # waits for the device
            total = (time.perf_counter() - t0) / args.repeat
        iters = max(res.n_iter, 1)
        refine_info = {}
        if args.refine:
            rcfg = SolverConfig(tol=tol, max_iter=args.max_iter,
                                dtype=dtype)
            x2, rk, rres = refine_shifted_solutions(prob.A, b, sigma,
                                                    res.x_set, rcfg)
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
            "devices": 1,
            "sigma_devices": 1,
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
    rows, _ = run_solve_shifted(args, report=_report)
    return 0 if all(r["all_converged"] for r in rows) else 2


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
    _add_layout(p)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to solve (default: the card; raises "
                        "without one)")
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
    p.add_argument("--repeat", type=int, default=1,
                   help="repeat the solve N times for timing stability "
                        "(main_repeat.c:109-132)")
    p.add_argument("--verbose-every", type=int, default=0, metavar="N",
                   help="print the seed relative residual every N "
                        "iterations, and each seed switch; 0 = silent")
    _add_layout(p)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to solve (default: the card; raises "
                        "without one)")
    p.set_defaults(fn=cmd_solve_shifted)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
