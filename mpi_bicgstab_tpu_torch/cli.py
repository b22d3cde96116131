"""Command-line entry point (counterpart of mpi_bicgstab_tpu/cli.py; the
reference's main.c).

    python -m mpi_bicgstab_tpu_torch solve --matrix transport-like:1602112 \\
        --method pipe_bicgstab --dtype float32 --tol 1e-6
    python -m mpi_bicgstab_tpu_torch solve --matrix banded:4096 \\
        --dtype df32 --tol 1e-11 --device cpu

Methods: bicgstab, ca_bicgstab, pipe_bicgstab, pipe_bicgstab_rr (with
--krr/--nrr), bicgstab_l2, bicgstab_l4. Matrices: a .mtx / .mtx.gz /
.npz path, or a generator spec 'poisson2d:N', 'poisson3d:N',
'transport-like:N', 'transport-hard:N', 'banded:N', 'skew:N'. The solve
runs on the card unless --device cpu asks for the CPU. It prints the
fields the JAX package's `solve` prints and exits 0 when the solve
converged, 2 when it did not.
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
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
