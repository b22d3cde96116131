"""Record per-iteration residual curves of the four classic methods on
the hard-convergence benchmark with the PyTorch/CUDA port: the
reference's residual figure (its README.md:44-51) at full 1.6M-row
scale, as scripts/record_curves.py records it with the JAX package.

    python scripts/record_curves_torch.py [n] [dtype] [tol] [max_iter]
        [--device cuda|cpu] [--out DIR]

Defaults: n = 1602112 (transport_hard: 117^3 = 1,601,613 rows), df32,
tol 1e-14, max_iter 6000, SolverConfig(krr=400, nrr=8), on the card,
into docs/data. Writes DIR/torch_hard{label}_{dtype}_{method}.csv
(iter,relres) and prints one JSON row per method: the JAX script's keys
(true_relres is ||b - A x|| / ||b|| recomputed on the host in float64)
plus eager_ms_per_iter and the card's name and power limit.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

METHODS = ("bicgstab", "ca_bicgstab", "pipe_bicgstab", "pipe_bicgstab_rr")
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs", "data")


def record_methods(csr, dtype_name: str = "df32", tol: float = 1e-14,
                   max_iter: int = 6000, device="cuda",
                   out_dir: str = DEFAULT_OUT, methods=METHODS,
                   after=None) -> list:
    """Solve csr's system b = A 1 with each of `methods` (krr 400, nrr 8:
    residual replacement fires several times inside the convergence),
    write each history as a CSV into out_dir, print one JSON row per
    method and return the rows. after(row), when given, runs after each
    method (a caller's per-method check)."""
    from mpi_bicgstab_tpu_torch.api import solve
    from mpi_bicgstab_tpu_torch.benchmarks.runner import card_census
    from mpi_bicgstab_tpu_torch.models.problem import build_problem
    from mpi_bicgstab_tpu_torch.ops.precision import df_to_f64, is_df
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig, canon_dtype

    prob = build_problem(csr, dtype=dtype_name, device=device)
    cuda = torch.device(device).type == "cuda"
    card = card_census() if cuda else {"device_name": None,
                                       "power_limit": None}
    label = f"{prob.n_logical // 1000}k"
    os.makedirs(out_dir, exist_ok=True)
    b64 = df_to_f64(prob.b) if is_df(prob.b) \
        else prob.b.cpu().numpy().astype(np.float64)
    nb = np.linalg.norm(b64)
    cfg = SolverConfig(tol=tol, max_iter=max_iter, krr=400, nrr=8,
                       dtype=canon_dtype(dtype_name))
    rows = []
    for method in methods:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(prob.A, prob.b, method=method, cfg=cfg)
        k = int(res.n_iter)     # reads the count back: the solve is done
        if cuda:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        hist = res.history[:k].cpu().numpy()
        path = os.path.join(out_dir,
                            f"torch_hard{label}_{dtype_name}_{method}.csv")
        np.savetxt(path, np.c_[np.arange(1, k + 1), hist],
                   header="iter,relres", delimiter=",", comments="")
        x64 = df_to_f64(res.x) if is_df(res.x) \
            else res.x.cpu().numpy().astype(np.float64)
        true_rel = float(np.linalg.norm(
            b64[: csr.nrows] - csr.matvec(x64[: csr.nrows])) / nb)
        row = {"method": method, "iters": k,
               "final_relres": float(res.final_relres),
               "true_relres": true_rel, "converged": bool(res.converged),
               "wall_s": round(dt, 3), "curve": os.path.basename(path),
               "eager_ms_per_iter": round(dt * 1e3 / max(k, 1), 4),
               "device_name": card["device_name"],
               "power_limit": card["power_limit"]}
        print(json.dumps(row), flush=True)
        rows.append(row)
        if after is not None:
            after(row)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", type=int, nargs="?", default=1_602_112)
    p.add_argument("dtype", nargs="?", default="df32")
    p.add_argument("tol", type=float, nargs="?", default=1e-14)
    p.add_argument("max_iter", type=int, nargs="?", default=6000)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out", default=DEFAULT_OUT)
    args = p.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)    # a shared host: one thread a process
    from mpi_bicgstab_tpu_torch.models.generators import transport_hard
    t0 = time.perf_counter()
    csr = transport_hard(args.n)
    print(json.dumps({"n": csr.nrows, "nnz": csr.nnz,
                      "gen_s": round(time.perf_counter() - t0, 1),
                      "device": args.device}), flush=True)
    record_methods(csr, args.dtype, args.tol, args.max_iter, args.device,
                   args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
