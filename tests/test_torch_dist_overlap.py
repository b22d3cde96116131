"""Communication hiding in the distributed layer (parallel/comm.py,
parallel/dist_spmv.py, solvers/bicgstab._pipe), the port's counterpart
of the JAX package's Comm.seq / serialize and SolverConfig.serialize_comm,
on the CPU with gloo ranks:

* the split-phase Comm (start, device work, wait) equals the blocking
  form (serialize: every collective waited at once) and the rank-order
  sum bit for bit, double-float pairs too, on 1, 2 and 4 ranks
  (chip_smoke.check_split_phase, the `[dist_overlap]` phase's helper);
* serialize_comm on and off give bit-equal iterates, histories and
  n_iter for the unfused classic, CA, pipelined and pipelined-RR solvers
  in float64, float32 and df32, on allgather, ring and halo partitions
  of 2 and 4 ranks;
* against the JAX package's solve_distributed with serialize_comm=True at
  the same device count (2 and 4): n_iter within 2, the float64 history
  within rtol 1e-6;
* under serialize_comm api.solve, fused_dist.applicable and
  batched_dist.applicable take the unfused route.

One module-scoped pool of 4 ranks runs every port solve (1- and 2-rank
solves leave the other ranks outside the grid)."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_bicgstab_tpu.models import generators as jgen
from mpi_bicgstab_tpu.parallel import driver as jdrv
from mpi_bicgstab_tpu.parallel.mesh import make_row_mesh as j_row_mesh
from mpi_bicgstab_tpu.parallel.partition import partition_csr as j_partition
from mpi_bicgstab_tpu.utils.config import SolverConfig as JConfig
from mpi_bicgstab_tpu_torch import api
from mpi_bicgstab_tpu_torch.models import generators as tgen
from mpi_bicgstab_tpu_torch.models.problem import build_problem
from mpi_bicgstab_tpu_torch.ops import cuda_fused_classic as fcl
from mpi_bicgstab_tpu_torch.parallel import driver, launch
from mpi_bicgstab_tpu_torch.parallel.partition import partition_csr
from mpi_bicgstab_tpu_torch.solvers import batched_dist, fused_dist
from mpi_bicgstab_tpu_torch.utils.config import SolverConfig

torch.set_num_threads(1)
SCRIPT = str(Path(__file__).resolve().parents[1] / "chip_smoke.py")


@pytest.fixture(scope="module")
def pool():
    with launch.Pool(4, device="cpu") as p:
        yield p


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_split_phase_equals_blocking(pool, ranks):
    out = pool.run(launch.call_script, SCRIPT, "check_split_phase", ranks,
                   "cpu")
    assert out["split_phase"] == "bit-equal to blocking and rank-order sums"
    assert out["kinds"] == "float32,float64,df32"


# partition kind -> (format, halo strategy)
KINDS = {"allgather": ("ell", "allgather"), "ring": ("ell", "ring"),
         "halo": ("auto", "allgather")}
METHODS = ["bicgstab", "ca_bicgstab", "pipe_bicgstab", "pipe_bicgstab_rr"]
TOLS = {"float64": 1e-10, "float32": 1e-5, "df32": 1e-10}


def _band(n=1200):
    return tgen.banded_random(n, [1, -1, 12, -12, 40, -40], seed=6)


@pytest.mark.parametrize("N", [2, 4])
@pytest.mark.parametrize("dtype", list(TOLS))
@pytest.mark.parametrize("method", METHODS)
def test_serialize_on_and_off_are_bit_equal(pool, method, dtype, N):
    csr = _band()
    b = csr.matvec(np.ones(csr.nrows))
    cfg = SolverConfig(tol=TOLS[dtype], max_iter=400, krr=3, nrr=2,
                       dtype="float32" if dtype == "df32" else dtype)
    for kind, (fmt, halo) in KINDS.items():
        part = partition_csr(csr, N, dtype=dtype, format=fmt)
        assert (part.dia_mode == "halo") == (kind == "halo")
        over = pool.run(driver.solve_distributed, part, b, method=method,
                        cfg=cfg, halo=halo, unfused=True)
        ser = pool.run(driver.solve_distributed, part, b, method=method,
                       cfg=cfg.replace(serialize_comm=True), halo=halo)
        assert over.n_iter == ser.n_iter, kind
        np.testing.assert_array_equal(over.history, ser.history)
        np.testing.assert_array_equal(launch.result_array(over.x),
                                      launch.result_array(ser.x))
        assert bool(over.converged), kind


@pytest.mark.parametrize("N", [2, 4])
@pytest.mark.parametrize("method", METHODS)
def test_serialize_matches_jax(pool, method, N):
    t = _band()
    j = jgen.banded_random(1200, [1, -1, 12, -12, 40, -40], seed=6)
    b = t.matvec(np.ones(t.nrows))
    kw = dict(tol=1e-10, max_iter=400, krr=3, nrr=2, serialize_comm=True)
    r = pool.run(driver.solve_distributed, partition_csr(t, N,
                                                         dtype="float64"),
                 b, method=method, cfg=SolverConfig(dtype="float64", **kw))
    rj = jdrv.solve_distributed(
        j_partition(j, N, dtype=np.dtype(np.float64)), b, method=method,
        mesh=j_row_mesh(N), cfg=JConfig(dtype=jnp.float64, **kw))
    assert bool(r.converged) and bool(rj.converged)
    it, jt = int(r.n_iter), int(rj.n_iter)
    assert abs(it - jt) <= 2
    m = min(it, jt)
    np.testing.assert_allclose(r.history[:m], np.asarray(rj.history)[:m],
                               rtol=1e-6)


def test_serialize_takes_the_unfused_route(monkeypatch):
    """api.solve on a float32 DIA problem runs the fused passes (their
    twins on the CPU) without serialize_comm and none with it; the
    distributed gates refuse it."""
    calls = []
    real = fcl.fused_k1_plain

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(fcl, "fused_k1_plain", counting)
    csr = _band()
    prob = build_problem(csr, dtype="float32", multiple=1, device="cpu")
    cfg = SolverConfig(tol=1e-5, dtype="float32")
    fused = api.solve(prob.A, prob.b, cfg=cfg)
    n_fused = len(calls)
    calls.clear()
    plain = api.solve(prob.A, prob.b, cfg=cfg.replace(serialize_comm=True))
    assert n_fused == fused.n_iter and not calls
    assert abs(plain.n_iter - fused.n_iter) <= 2
    shard = partition_csr(csr, 2, dtype="float32").shard(
        0, torch.device("cpu"))
    b = torch.zeros(shard.n_loc)
    ser = cfg.replace(serialize_comm=True)
    assert fused_dist.applicable(shard, "bicgstab", b, cfg)
    assert not fused_dist.applicable(shard, "bicgstab", b, ser)
    B = torch.zeros(3, shard.n_loc)
    assert batched_dist.applicable(shard, "bicgstab", B, cfg)
    assert not batched_dist.applicable(shard, "bicgstab", B, ser)
