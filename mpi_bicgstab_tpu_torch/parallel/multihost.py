"""One node of a multi-host distributed solve (counterpart of the JAX
package's scripts/multihost_worker.py; the reference launches mpirun over
its nodes, run.bash:2-9).

    python -m mpi_bicgstab_tpu_torch.parallel.multihost \
        --master HOST:PORT --nnodes K --node-rank i --nproc-per-node m \
        [--n N] [--method M] [--dtype D] [--shifted] [--device cpu]

Each node process spawns its m local ranks (parallel/launch.Pool), the
global ranks i*m .. i*m + m - 1 of a world of K*m, which meet the other
nodes' ranks over tcp://HOST:PORT: the address torchrun's MASTER_ADDR and
MASTER_PORT name, where global rank 0 serves the store. The ranks are
CUDA ranks on cuda:<local rank> (NCCL), or gloo ranks with --device cpu.
Every rank builds the same banded_random(n, [1, -1, 16, -16], seed=3)
problem from the generator (no shared file system), partitions it over
the whole world and solves it distributed (parallel/driver.py); each
node prints the JAX worker's sentinel line, one JSON object with
sentinel MULTIHOST_OK (or MULTIHOST_FAIL), process_id, process_count,
global_devices, local_devices, n_iter and final_relres, and exits 0 when
the solve succeeded.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

SHIFTS = (0.0, 0.05, 0.2, 1.0)
SHIFTED_SEED = 3


def solve_rank(n: int, method: str, dtype: str, shifted: bool,
               device: str) -> dict:
    """A rank's part of the node's solve (a launch.Pool task): the whole
    world's partition of the problem, solved; the sentinel's numbers."""
    import torch
    import torch.distributed as dist

    from mpi_bicgstab_tpu_torch.models.generators import banded_random
    from mpi_bicgstab_tpu_torch.parallel.driver import (
        solve_distributed, solve_shifted_distributed)
    from mpi_bicgstab_tpu_torch.parallel.launch import result_array
    from mpi_bicgstab_tpu_torch.parallel.mesh import make_row_mesh
    from mpi_bicgstab_tpu_torch.parallel.partition import partition_csr
    world = dist.get_world_size()
    csr = banded_random(n, [1, -1, 16, -16], seed=3)
    dt = dtype if dtype == "df32" else getattr(torch, dtype)
    part = partition_csr(csr, world, dtype=dt)
    mesh = make_row_mesh(world, device)
    b = csr.matvec(np.ones(csr.nrows))
    if shifted:
        res = solve_shifted_distributed(
            part, b, np.asarray(SHIFTS), seed=SHIFTED_SEED,
            method="shifted_lopbicg_switching", mesh=mesh)
        ok = bool(res.stop_flags.all())
    else:
        res = solve_distributed(part, b, method=method, mesh=mesh)
        ok = bool(res.converged)
        if dtype == "float64":
            x = result_array(res.x.cpu().numpy())
            expect = (np.arange(x.shape[0]) < csr.nrows).astype(np.float64)
            ok = ok and bool(np.abs(x - expect).max() < 1e-8)
    return {"ok": ok, "n_iter": int(res.n_iter),
            "final_relres": float(res.final_relres), "world": world}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mpi_bicgstab_tpu_torch.parallel.multihost",
        description="one node of a multi-host distributed solve")
    ap.add_argument("--master", required=True, metavar="HOST:PORT",
                    help="where global rank 0 serves the store")
    ap.add_argument("--nnodes", type=int, required=True)
    ap.add_argument("--node-rank", type=int, required=True)
    ap.add_argument("--nproc-per-node", type=int, default=1)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--method", default="bicgstab")
    ap.add_argument("--shifted", action="store_true")
    ap.add_argument("--dtype", default="float64",
                    choices=["float32", "float64", "df32"])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if not 0 <= args.node_rank < args.nnodes:
        raise SystemExit(f"--node-rank {args.node_rank} outside "
                         f"[0, {args.nnodes})")
    from mpi_bicgstab_tpu_torch.parallel import launch
    # the task by its module's name: run as __main__, this file's own
    # function would make the ranks import __main__
    from mpi_bicgstab_tpu_torch.parallel.multihost import solve_rank as task
    from mpi_bicgstab_tpu_torch.utils.device import resolve_device
    resolve_device(args.device)
    m = args.nproc_per_node
    with launch.Pool(m, args.device, init_method=f"tcp://{args.master}",
                     first_rank=args.node_rank * m,
                     world_size=args.nnodes * m) as pool:
        out = pool.run(task, args.n, args.method, args.dtype,
                       args.shifted, args.device)
    print(json.dumps({
        "sentinel": "MULTIHOST_OK" if out["ok"] else "MULTIHOST_FAIL",
        "process_id": args.node_rank,
        "process_count": args.nnodes,
        "global_devices": out["world"],
        "local_devices": m,
        "n_iter": out["n_iter"],
        "final_relres": out["final_relres"],
    }), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
