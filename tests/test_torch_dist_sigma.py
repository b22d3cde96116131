"""The shifted family over the port's process grid (parallel/sigma.py
SigmaComm, parallel/driver.solve_shifted_distributed,
refine_shifted_distributed) on a gloo group of 4 CPU ranks: a 2 x 2
(rows x sigma) grid reproduces the rows-only run at the same row count
bit for bit, as the JAX package's tests/test_sigma_mesh.py holds JAX
(float64 and df32, per-iteration and blocked updates, across a real seed
switch); each solve agrees with the JAX package's at the same grid; the
refinement runs over the mesh; and --sigma-devices must divide the
ladder. One module-scoped pool of 4 ranks (parallel/launch.Pool)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_bicgstab_tpu.models import generators as jgen
from mpi_bicgstab_tpu.parallel import driver as jdrv
from mpi_bicgstab_tpu.parallel.mesh import make_grid_mesh as j_grid_mesh
from mpi_bicgstab_tpu.parallel.mesh import make_row_mesh as j_row_mesh
from mpi_bicgstab_tpu.parallel.partition import partition_csr as j_partition
from mpi_bicgstab_tpu.utils.config import ShiftedConfig as JShifted
from mpi_bicgstab_tpu.utils.config import SolverConfig as JSolver
from mpi_bicgstab_tpu_torch.models import generators as tgen
from mpi_bicgstab_tpu_torch.parallel import driver, launch
from mpi_bicgstab_tpu_torch.parallel.partition import partition_csr
from mpi_bicgstab_tpu_torch.parallel.sigma import SigmaComm
from mpi_bicgstab_tpu_torch.utils.config import ShiftedConfig, SolverConfig

torch.set_num_threads(1)
SIGMA8 = np.array([0.0, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0, 4.0])


@pytest.fixture(scope="module")
def pool():
    with launch.Pool(4, device="cpu") as p:
        yield p


def _fixture(seed_idx, n=1024):
    t = tgen.banded_random(n, [1, -1, 9, -9], seed=2)
    j = jgen.banded_random(n, [1, -1, 9, -9], seed=2)
    b = t.matvec(np.ones(n)) + SIGMA8[seed_idx] * np.ones(n)
    return t, j, b


def _x(x_set):
    return launch.result_array(x_set)


def _jx(x):
    if hasattr(x, "hi"):
        return np.asarray(x.hi, np.float64) + np.asarray(x.lo, np.float64)
    return np.asarray(x, np.float64)


def _same_run(r1, rG):
    assert int(rG.n_iter) == int(r1.n_iter)
    assert int(rG.final_seed) == int(r1.final_seed)
    assert float(rG.final_relres) == float(r1.final_relres)
    np.testing.assert_array_equal(np.asarray(rG.stop_flags),
                                  np.asarray(r1.stop_flags))
    for a, b in ((rG.x_set, r1.x_set),) if not hasattr(rG.x_set, "hi") \
            else ((rG.x_set.hi, r1.x_set.hi), (rG.x_set.lo, r1.x_set.lo)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method,seed_idx", [
    ("shifted_lopbicg_switching", 7),    # decaying seed: a real switch
    ("shifted_bicgstab", 0),
    ("shifted_lopbicgstab", 4),
    ("shifted_pipe_lopbicgstab", 4),
    ("shifted_lopbicg", 4),
])
def test_sigma_grid_bitequal_to_rows_only(pool, method, seed_idx):
    t, j, b = _fixture(seed_idx)
    part = partition_csr(t, 2)
    cfg = ShiftedConfig(tol=1e-11, max_iter=800, shift_block=0)
    kw = dict(method=method, cfg=cfg)
    if method != "shifted_bicgstab":
        kw["seed"] = seed_idx
    r1 = pool.run(driver.solve_shifted_distributed, part, b, SIGMA8, **kw)
    rG = pool.run(driver.solve_shifted_distributed, part, b, SIGMA8, **kw,
                  sigma_devices=2)
    _same_run(r1, rG)
    assert bool(np.asarray(rG.stop_flags).all())
    if method == "shifted_lopbicg_switching":
        assert int(rG.final_seed) != seed_idx, "the fixture must switch"
    # the JAX package on its 2 x 2 grid
    jp = j_partition(j, 2)
    rj = jdrv.solve_shifted_distributed(
        jp, b, SIGMA8, mesh=j_grid_mesh(2, 2), sigma_devices=2,
        **{**kw, "cfg": JShifted(tol=1e-11, max_iter=800, shift_block=0)})
    assert abs(int(rG.n_iter) - int(rj.n_iter)) <= 2
    assert int(rG.final_seed) == int(rj.final_seed)
    np.testing.assert_allclose(rG.x_set, _jx(rj.x_set), rtol=0, atol=1e-8)
    for jj, sg in enumerate(SIGMA8):
        xj = rG.x_set[jj][: t.nrows]
        r = t.matvec(xj) + sg * xj - b
        assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-8, jj


def test_sigma_grid_df32_bitequal(pool):
    t, j, b = _fixture(4)
    part = partition_csr(t, 2, dtype="df32")
    cfg = ShiftedConfig(tol=1e-9, max_iter=800, shift_block=0,
                        dtype="df32")
    kw = dict(seed=4, method="shifted_lopbicg_switching", cfg=cfg)
    r1 = pool.run(driver.solve_shifted_distributed, part, b, SIGMA8, **kw)
    rG = pool.run(driver.solve_shifted_distributed, part, b, SIGMA8, **kw,
                  sigma_devices=2)
    _same_run(r1, rG)
    rj = jdrv.solve_shifted_distributed(
        j_partition(j, 2, dtype="df32"), b, SIGMA8, seed=4,
        method="shifted_lopbicg_switching", mesh=j_grid_mesh(2, 2),
        sigma_devices=2, cfg=JShifted(tol=1e-9, max_iter=800,
                                      shift_block=0, dtype="df32"))
    assert abs(int(rG.n_iter) - int(rj.n_iter)) <= 2
    np.testing.assert_allclose(_x(rG.x_set), _jx(rj.x_set), rtol=0,
                               atol=1e-8)


def test_sigma_grid_blocked_flush(pool):
    # the blocked updates: each group flushes its rows of the [S, L]
    # coefficient blocks against its slab
    t, _, b = _fixture(7)
    part = partition_csr(t, 2)
    cfg = ShiftedConfig(tol=1e-11, max_iter=800, shift_block=7)
    kw = dict(seed=7, method="shifted_lopbicg_switching", cfg=cfg)
    r1 = pool.run(driver.solve_shifted_distributed, part, b, SIGMA8, **kw)
    rG = pool.run(driver.solve_shifted_distributed, part, b, SIGMA8, **kw,
                  sigma_devices=2)
    assert int(rG.n_iter) == int(r1.n_iter)
    assert int(rG.final_seed) == int(r1.final_seed) != 7
    np.testing.assert_allclose(rG.x_set, r1.x_set, rtol=1e-12, atol=1e-12)
    for jj, sg in enumerate(SIGMA8):
        xj = rG.x_set[jj][: t.nrows]
        r = t.matvec(xj) + sg * xj - b
        assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-8, jj


def test_refine_over_the_mesh_matches_jax(pool):
    t, j, b = _fixture(4)
    part = partition_csr(t, 2)
    res = pool.run(driver.solve_shifted_distributed, part, b, SIGMA8,
                   seed=4, method="shifted_lopbicg_switching",
                   cfg=ShiftedConfig(tol=1e-8, max_iter=800, shift_block=0),
                   sigma_devices=2)
    x2, k, rres = pool.run(driver.refine_shifted_distributed, part, b,
                           SIGMA8, res.x_set,
                           SolverConfig(tol=1e-11, max_iter=200), chunk=3)
    assert float(np.asarray(rres).max()) < 1e-11 and k >= 1
    for jj, sg in enumerate(SIGMA8):
        xj = x2[jj][: t.nrows]
        r = t.matvec(xj) + sg * xj - b
        assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-10, jj
    jp = j_partition(j, 2)
    mesh = j_row_mesh(2)
    x2j, kj, _ = jdrv.refine_shifted_distributed(
        jp, b, SIGMA8, jnp.asarray(res.x_set), JSolver(tol=1e-11,
                                                       max_iter=200),
        mesh=mesh, chunk=3)
    assert abs(k - int(kj)) <= 2
    np.testing.assert_allclose(x2, _jx(x2j), rtol=0, atol=1e-10)


def test_sigma_devices_must_divide_ladder():
    t, j, b = _fixture(0)
    cfg = ShiftedConfig(tol=1e-8, max_iter=50)
    for fn, p in ((driver.solve_shifted_distributed, partition_csr(t, 2)),
                  (jdrv.solve_shifted_distributed, j_partition(j, 2))):
        with pytest.raises(ValueError, match="not divisible"):
            fn(p, b, SIGMA8[:6], seed=0, method="shifted_lopbicgstab",
               cfg=cfg if fn is driver.solve_shifted_distributed
               else JShifted(tol=1e-8, max_iter=50), sigma_devices=4)
    with pytest.raises(ValueError, match="sigma_devices must be >= 1"):
        driver.solve_shifted_distributed(partition_csr(t, 2), b, SIGMA8,
                                         sigma_devices=0)


def test_sigma_comm_trivial_and_geometry():
    sc = SigmaComm()
    assert sc.s_local(8) == 8 and sc.loc(torch.arange(8)).shape == (8,)
    with pytest.raises(ValueError, match="agree"):
        SigmaComm(groups=2)
    with pytest.raises(ValueError, match="not divisible"):
        SigmaComm(type("C", (), {"size": 3, "rank": 0})(), 3).s_local(8)
