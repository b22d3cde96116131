"""The multi-host launch (mpi_bicgstab_tpu_torch/parallel/multihost.py),
the port's counterpart of the JAX package's scripts/multihost_worker.py
and tests/test_multihost.py: two OS processes, each a node that spawns
two gloo ranks, meet over tcp://127.0.0.1:<free port> as one world of
four. Each node prints the JAX worker's sentinel line with MULTIHOST_OK
and global_devices 4, and its n_iter and final_relres equal a 4-rank
launch.run solve of the same problem bit for bit, plain and --shifted.
One test (it starts six rank processes)."""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the test files import both packages)
import torch

import mpi_bicgstab_tpu  # noqa: F401
from mpi_bicgstab_tpu_torch.parallel import launch, multihost

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _nodes(extra, timeout=300):
    """The two nodes' sentinel lines."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mpi_bicgstab_tpu_torch.parallel.multihost",
         "--master", f"127.0.0.1:{port}", "--nnodes", "2", "--node-rank",
         str(i), "--nproc-per-node", "2", "--device", "cpu", *extra],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    rows = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-2000:]
            line = [ln for ln in out.splitlines() if "sentinel" in ln][-1]
            rows.append(json.loads(line))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rows


def test_two_nodes_over_tcp_equal_a_four_rank_solve():
    for shifted in (False, True):
        rows = _nodes(["--shifted"] if shifted else [])
        want = launch.run(multihost.solve_rank, 4, 4096, "bicgstab",
                          "float64", shifted, "cpu", device="cpu")
        assert want["ok"] and want["world"] == 4
        for i, r in enumerate(rows):
            assert r["sentinel"] == "MULTIHOST_OK", r
            assert (r["process_id"], r["process_count"]) == (i, 2)
            assert (r["global_devices"], r["local_devices"]) == (4, 2)
            assert r["n_iter"] == want["n_iter"], (shifted, r)
            assert r["final_relres"] == want["final_relres"], (shifted, r)
