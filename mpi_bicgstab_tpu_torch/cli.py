"""Command-line entry point (counterpart of mpi_bicgstab_tpu/cli.py; the
reference's main.c).

    python -m mpi_bicgstab_tpu_torch solve --matrix transport-like:1602112 \\
        --method pipe_bicgstab --dtype float32 --tol 1e-6
    python -m mpi_bicgstab_tpu_torch solve --matrix banded:4096 \\
        --dtype df32 --tol 1e-11 --device cpu

    python -m mpi_bicgstab_tpu_torch solve-shifted \\
        --matrix transport-like:1602112 --dtype df32 --sigma-len 512 \\
        --sigma-max 0.01 --seed 255 --tol 1e-10

`solve` methods: bicgstab, ca_bicgstab, pipe_bicgstab, pipe_bicgstab_rr (with
--krr/--nrr), bicgstab_l2, bicgstab_l4. Matrices: a .mtx / .mtx.gz /
.npz path, or a generator spec 'poisson2d:N', 'poisson3d:N',
'transport-like:N', 'transport-hard:N', 'banded:N', 'skew:N'. The solve
runs on the card unless --device cpu asks for the CPU. It prints the
fields the JAX package's `solve` prints and exits 0 when the solve
converged, 2 when it did not. `solve-shifted` (reference main_shifted.c)
solves a ladder of shifted systems with the seed-switching solver or
another shifted method, prints the JAX package's solve-shifted fields,
and exits 0 when every shift converged, 2 otherwise.
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
        elif kind in ("clustered", "uniform"):
            raise SystemExit(f"generator {kind!r} is not ported yet: "
                             f"ROADMAP slice 6 (unstructured layouts)")
        else:
            raise SystemExit(f"unknown generator {kind!r}")
    else:
        csr = load_csr(spec, dtype=np.float64)
    return csr, time.perf_counter() - t0


def _load_rhs(spec: str, n: int) -> np.ndarray:
    """A user right-hand side: .npy, or a Matrix Market vector (array
    n x 1 or coordinate; duplicate coordinate entries sum)."""
    if spec.endswith(".npy"):
        b = np.load(spec)
    else:
        from mpi_bicgstab_tpu_torch.io.mmio import read_matrix_market
        rows, cols, vals, shape = read_matrix_market(spec)
        if 1 not in shape:
            raise SystemExit(f"--rhs {spec}: expected a vector, got {shape}")
        b = np.zeros(max(shape))
        np.add.at(b, rows if shape[1] == 1 else cols, vals)
    b = np.asarray(b, np.float64).ravel()
    if b.size != n:
        raise SystemExit(f"--rhs has {b.size} entries, matrix has {n} rows")
    return b


_SEED = 255         # main_shifted.c:14


def _report(payload: dict) -> None:
    for k, v in payload.items():
        print(f"{k:>16s}: {v}")


def run_solve(args):
    """The `solve` command without its printing: returns (report, result)
    where report holds the fields the JAX package's `solve` prints."""
    import torch

    from mpi_bicgstab_tpu_torch.api import solve
    from mpi_bicgstab_tpu_torch.models.problem import build_problem
    from mpi_bicgstab_tpu_torch.ops.precision import (df_from_f64,
                                                      df_to_f64, is_df)
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
    from mpi_bicgstab_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    df = args.dtype == "df32"
    # "df32" builds DF pairs; its config dtype is float32 (canon_dtype)
    dtype = args.dtype if df else getattr(torch, args.dtype)
    csr, io_time = _load_matrix(args.matrix)
    cfg = SolverConfig(tol=args.tol, max_iter=args.max_iter, krr=args.krr,
                       nrr=args.nrr, dtype=dtype, restarts=args.restarts)
    prob = build_problem(csr, dtype=dtype, multiple=1, device=dev)
    b = prob.b
    if args.rhs:
        b_host = _load_rhs(args.rhs, csr.nrows)
        b = df_from_f64(b_host, dev) if df else torch.as_tensor(
            b_host, dtype=dtype, device=dev)
    if dev.type == "cuda":
        from mpi_bicgstab_tpu_torch.ops import _build
        _build.build_all()    # the kernel build is set-up, not solve time
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = solve(prob.A, b, method=args.method, cfg=cfg)
    converged = bool(res.converged)      # waits for the device
    total = time.perf_counter() - t0
    done = res.n_iter
    if args.write_solution:
        x = df_to_f64(res.x) if is_df(res.x) else \
            res.x.double().cpu().numpy()
        np.save(args.write_solution, x[: csr.nrows])
    report = {
        "method": args.method,
        "matrix": args.matrix,
        "n": csr.nrows,
        "nnz": csr.nnz,
        "devices": 1,
        "device": str(dev),
        "reordered": False,
        "scaled": False,
        "precond": "none",
        "io_time_s": round(io_time, 6),
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


def cmd_solve(args) -> int:
    report, _ = run_solve(args)
    _report(report)
    return 0 if report["converged"] else 2


def _ladder(args, S: int):
    """(sigma, seed) of one ladder length: main_shifted.c:95-100,
    sigma_i = (i + 1) sigma_max / len, or, for --sigma-len-sweep,
    main_seed_diff.c:15-17, sigma_i = 0.01 + i sigma_max / len with the
    seed clamped into the ladder. Without --seed the seed is the
    reference's 255 (main_shifted.c:14), clamped into a shorter ladder;
    an explicit --seed outside the ladder is refused."""
    if args.sigma_len_sweep or args.seed is None:
        seed = min(_SEED if args.seed is None else args.seed, S - 1)
    else:
        seed = args.seed
    if args.sigma_len_sweep:
        return 0.01 + np.arange(S) * (args.sigma_max / S), seed
    if not 0 <= seed < S:
        raise SystemExit(f"--seed {args.seed} out of range for --sigma-len "
                         f"{S} (the sweep mode clamps; the direct mode "
                         f"wants an explicit in-range seed)")
    return (np.arange(S) + 1) * (args.sigma_max / S), seed


def _check_shifted_args(args) -> None:
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
    from mpi_bicgstab_tpu_torch.models.problem import build_problem
    from mpi_bicgstab_tpu_torch.ops.precision import (df_from_f64,
                                                      df_to_f64, is_df)
    from mpi_bicgstab_tpu_torch.utils.config import (ShiftedConfig,
                                                     SolverConfig)
    from mpi_bicgstab_tpu_torch.utils.device import resolve_device

    _check_shifted_args(args)
    dev = resolve_device(args.device)
    df = args.dtype == "df32"
    dtype = args.dtype if df else getattr(torch, args.dtype)
    csr, io_time = _load_matrix(args.matrix)
    n = csr.nrows
    b_user = _load_rhs(args.rhs, n) if args.rhs else None
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
        prob = build_problem(csr, dtype=dtype, multiple=1, device=dev,
                             sigma_seed=float(sigma[seed]))
        b = prob.b
        if b_user is not None:
            b = df_from_f64(b_user, dev) if df else torch.as_tensor(
                b_user, dtype=dtype, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if args.checkpoint:
            meta = {"n": n, "nnz": int(csr.nnz), "matrix": args.matrix,
                    "dtype": args.dtype, "sigma_len": S, "seed": int(seed),
                    "sigma_max": float(args.sigma_max), "tol": float(tol),
                    "reorder": "none",
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
        if args.write_solution or args.check_error:
            xs = df_to_f64(res.x_set) if is_df(res.x_set) else \
                res.x_set.double().cpu().numpy()
            xs = xs[:, :n]
            if args.write_solution:
                np.save(args.write_solution, xs)
            if args.check_error:
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
                        "banded:N, skew:N)")
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
    p.add_argument("--write-solution", default=None, metavar="FILE",
                   help="save the solution x (float64) as .npy")
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
    p.add_argument("--seed", type=int, default=None,
                   help=f"seed system's index in the ladder (default "
                        f"{_SEED}, the reference's, or the last shift of a "
                        f"shorter ladder)")
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
                   help="save the [sigma_len, n] solutions (float64) as "
                        ".npy")
    p.add_argument("--repeat", type=int, default=1,
                   help="repeat the solve N times for timing stability "
                        "(main_repeat.c:109-132)")
    p.add_argument("--verbose-every", type=int, default=0, metavar="N",
                   help="print the seed relative residual every N "
                        "iterations, and each seed switch; 0 = silent")
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
