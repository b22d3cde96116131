"""Quickstart: the PyTorch/CUDA port's library API end to end.

    python examples/quickstart_torch.py                      # the card
    python examples/quickstart_torch.py --device cpu         # no card
    python examples/quickstart_torch.py --device cpu --ranks 8

Covers: building a system, the classic and shifted solves, df32
extended precision, Chebyshev preconditioning, batched right-hand sides,
the distributed row partition (one rank per card, or gloo ranks on the
CPU), BiCGStab(l) and the rows x sigma grid. Each section is a function
of the device (and of the rank count for the mesh sections) that
returns its printed line and its result; main() runs them in order.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mpi_bicgstab_tpu_torch.api import (solve, solve_batched,  # noqa: E402
                                        solve_shifted)
from mpi_bicgstab_tpu_torch.models.generators import (  # noqa: E402
    banded_random, skew_banded, transport_hard)
from mpi_bicgstab_tpu_torch.models.problem import build_problem  # noqa: E402
from mpi_bicgstab_tpu_torch.ops.cheby import (ChebyPrecond,  # noqa: E402
                                              estimate_bounds)
from mpi_bicgstab_tpu_torch.ops.precision import df_to_f64  # noqa: E402
from mpi_bicgstab_tpu_torch.utils.config import (ShiftedConfig,  # noqa: E402
                                                 SolverConfig)


def system():
    """The quickstart's system (or: csr = ops.sparse.load_csr("yours.mtx"))."""
    return banded_random(4096, [1, -1, 16, -16], seed=0)


def classic(device):
    csr = system()
    prob = build_problem(csr, dtype=torch.float64, device=device)  # b = A 1
    res = solve(prob.A, prob.b, method="pipe_bicgstab",
                cfg=SolverConfig(tol=1e-10, max_iter=1000))
    x = res.x.cpu().numpy()
    return (f"pipe_bicgstab: {int(res.n_iter)} iters, "
            f"relres {float(res.final_relres):.2e}, "
            f"max|x-1| {np.abs(x[:csr.nrows] - 1).max():.2e}"), res


def shifted(device):
    """(A + sigma_j I) x_j = b from ONE Krylov sequence."""
    prob = build_problem(system(), dtype=torch.float64, device=device)
    sigma = np.array([0.0, 0.01, 0.05, 0.2])
    res = solve_shifted(prob.A, prob.b, sigma, seed=0,
                        method="shifted_lopbicg_switching",
                        cfg=ShiftedConfig(tol=1e-10, max_iter=1000))
    return (f"shifted ({sigma.size} shifts): {int(res.n_iter)} iters, "
            f"all converged: {bool(res.stop_flags.all())}"), res


def df32(device):
    """float64-class precision from float32 pairs."""
    csr = system()
    prob = build_problem(csr, dtype="df32", device=device)
    res = solve(prob.A, prob.b, method="bicgstab",
                cfg=SolverConfig(tol=1e-12, max_iter=1000,
                                 dtype=torch.float32))
    x = df_to_f64(res.x)
    return (f"df32: relres {float(res.final_relres):.2e}, "
            f"max|x-1| {np.abs(x[:csr.nrows] - 1).max():.2e} "
            f"(plain f32 floors at ~1e-7)"), res


def cheby(device):
    """Chebyshev preconditioning: ~10x fewer iterations on hard systems."""
    csr_h = transport_hard(4096)
    prob_h = build_problem(csr_h, device=device)
    lo, hi = estimate_bounds(csr_h)
    cfg = SolverConfig(tol=1e-10, max_iter=3000)
    r_plain = solve(prob_h.A, prob_h.b, cfg=cfg)
    r_prec = solve(prob_h.A, prob_h.b, cfg=cfg,
                   precond=ChebyPrecond(degree=8, lo=lo, hi=hi))
    return (f"hard regime: {int(r_plain.n_iter)} iters plain -> "
            f"{int(r_prec.n_iter)} with cheby:8"), (r_plain, r_prec)


def batched(device):
    """k solves for about the memory traffic of one."""
    csr = system()
    prob = build_problem(csr, dtype=torch.float64, device=device)
    rng = np.random.default_rng(0)
    B = np.stack([csr.matvec(rng.standard_normal(csr.nrows))
                  for _ in range(4)])
    Bp = np.zeros((4, prob.n))
    Bp[:, : csr.nrows] = B
    res = solve_batched(prob.A, torch.as_tensor(Bp, device=prob.b.device),
                        cfg=SolverConfig(tol=1e-10, max_iter=1000))
    return (f"batched 4-RHS: n_iter per system "
            f"{res.n_iter.tolist()}, all converged: "
            f"{bool(res.converged.all())}"), res


def distributed(device, ranks):
    """The row partition over `ranks` ranks (one per card, or gloo ranks
    on the CPU); None with one rank."""
    if ranks <= 1:
        return ("(1 device visible — run with --device cpu --ranks 8 "
                "for the mesh demo)"), None
    from mpi_bicgstab_tpu_torch.parallel import driver, launch
    from mpi_bicgstab_tpu_torch.parallel.partition import partition_csr
    csr = system()
    part = partition_csr(csr, ranks, dtype=np.float64)
    b = csr.matvec(np.ones(csr.nrows))
    res = launch.run(driver.solve_distributed, ranks, part, b,
                     method="pipe_bicgstab",
                     cfg=SolverConfig(tol=1e-10, max_iter=1000),
                     device=device)
    return (f"distributed over {ranks} devices: {int(res.n_iter)} iters, "
            f"converged: {bool(res.converged)}"), res


def bicgstab_l(device):
    """BiCGStab(l): spectra the classic family cannot solve."""
    prob_s = build_problem(skew_banded(1024), device=device)
    r_classic = solve(prob_s.A, prob_s.b, method="bicgstab",
                      cfg=SolverConfig(tol=1e-10, max_iter=2000, restarts=0))
    r_l2 = solve(prob_s.A, prob_s.b, method="bicgstab_l2",
                 cfg=SolverConfig(tol=1e-10, max_iter=2000, restarts=0))
    return (f"skew-dominant spectrum: classic converged="
            f"{bool(r_classic.converged)} (true relres "
            f"{float(r_classic.true_relres):.1e}); bicgstab_l2 converged="
            f"{bool(r_l2.converged)} in {int(r_l2.n_iter)} iters"), \
        (r_classic, r_l2)


def sigma_grid(device, ranks):
    """The shift ladder's [S, n] slabs on a second axis: 2 rows x 4 sigma
    ranks; None with fewer than 8 ranks."""
    if ranks < 8:
        return None, None
    from mpi_bicgstab_tpu_torch.parallel import driver, launch
    from mpi_bicgstab_tpu_torch.parallel.partition import partition_csr
    csr = system()
    sig = np.array([0.0, 0.02, 0.1, 0.5])
    b_s = csr.matvec(np.ones(csr.nrows)) + sig[3] * np.ones(csr.nrows)
    part2 = partition_csr(csr, 2, dtype=np.float64)
    res = launch.run(driver.solve_shifted_distributed, 8, part2, b_s, sig,
                     seed=3, cfg=ShiftedConfig(tol=1e-10, max_iter=1000),
                     sigma_devices=4, device=device)
    return (f"sigma-sharded (2 rows x 4 sigma): {int(res.n_iter)} iters, "
            f"all shifts stopped: {bool(np.asarray(res.stop_flags).all())}"
            ), res


SECTIONS = (classic, shifted, df32, cheby, batched, distributed, bicgstab_l,
            sigma_grid)
MESH = (distributed, sigma_grid)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--ranks", type=int, default=None,
                   help="ranks of the mesh sections (default: the card "
                        "count on cuda, 1 on cpu)")
    args = p.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)    # a shared host: one thread a process
    ranks = args.ranks if args.ranks is not None else (
        torch.cuda.device_count() if args.device == "cuda" else 1)
    for section in SECTIONS:
        line, _ = (section(args.device, ranks) if section in MESH
                   else section(args.device))
        if line is not None:
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
