"""The port's distributed SpMV and solves (parallel/dist_spmv.py,
parallel/driver.py) on a gloo group of CPU ranks, against the JAX
package's on its virtual CPU devices at the same device count (2 and 4):
each format's SpMV (<= 1e-12 relative in float64 and DF, 1e-5 in
float32; ring against allgather), the classic family (n_iter within 2,
the early history within rtol 1e-6 in float64; float32 and df32 too),
the restart rescue, Chebyshev preconditioning, the batched form with
lane restarts, and the refusals. One module-scoped pool of 4 ranks runs every port
solve (parallel/launch.Pool)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_bicgstab_tpu.models import generators as jgen
from mpi_bicgstab_tpu.ops.cheby import ChebyPrecond as JCheby
from mpi_bicgstab_tpu.parallel import driver as jdrv
from mpi_bicgstab_tpu.parallel.mesh import make_row_mesh as j_row_mesh
from mpi_bicgstab_tpu.parallel.partition import partition_csr as j_partition
from mpi_bicgstab_tpu.utils.config import SolverConfig as JConfig
from mpi_bicgstab_tpu_torch.models import generators as tgen
from mpi_bicgstab_tpu_torch.ops.cheby import ChebyPrecond
from mpi_bicgstab_tpu_torch.parallel import driver, launch
from mpi_bicgstab_tpu_torch.parallel.mesh import Mesh
from mpi_bicgstab_tpu_torch.parallel.partition import partition_csr
from mpi_bicgstab_tpu_torch.utils.config import SolverConfig

torch.set_num_threads(1)
JDT = {"float64": np.dtype(np.float64), "float32": np.dtype(np.float32),
       "df32": "df32"}
TOL = {"float64": 1e-12, "float32": 1e-5, "df32": 1e-12}


@pytest.fixture(scope="module")
def pool():
    with launch.Pool(4, device="cpu") as p:
        yield p


def _both(name, *args, **kw):
    t, j = getattr(tgen, name)(*args, **kw), getattr(jgen, name)(*args, **kw)
    np.testing.assert_array_equal(t.val, j.val)
    return t, j


def _jx(x):
    """A JAX result vector as float64 (a DF pair's hi + lo)."""
    if hasattr(x, "hi"):
        return np.asarray(x.hi, np.float64) + np.asarray(x.lo, np.float64)
    return np.asarray(x, np.float64)


def _jvec(v, part, mesh, dtype):
    return jdrv.put_vector(v, part, mesh, dtype)


SPMV = {   # case -> (generator, args, kwargs, N, format)
    "dia_halo": ("banded_random", (1000, [1, -1, 9, -9]), {"seed": 0}, 4,
                 "auto"),
    "dia_gather": ("banded_random", (400, [1, -1, 70, -70]), {"seed": 1}, 4,
                   "dia"),
    "hybrid": ("poisson2d", (24,), {}, 2, "dia"),
    "ell": ("random_diag_dominant", (500, 7), {"seed": 2}, 4, "ell"),
    "window": ("clustered_random", (4096,), {}, 2, "window"),
    "butterfly": ("random_diag_dominant", (4096,),
                  {"nnz_per_row": 6, "seed": 0}, 2, "butterfly"),
}


@pytest.fixture
def _small_window_tiles(monkeypatch):
    from mpi_bicgstab_tpu.ops import pallas_window_spmv as jpws
    monkeypatch.setattr(jpws, "_TB", 1)


@pytest.mark.usefixtures("_small_window_tiles")
@pytest.mark.parametrize("dtype", ["float64", "float32", "df32"])
@pytest.mark.parametrize("case", sorted(SPMV))
def test_dist_spmv_matches_jax_and_host(pool, case, dtype):
    gen, args, kw, N, fmt = SPMV[case]
    t, j = _both(gen, *args, **kw)
    tp = partition_csr(t, N, dtype=dtype, format=fmt)
    jp = j_partition(j, N, dtype=JDT[dtype], format=fmt)
    x = np.random.default_rng(3).standard_normal(tp.n_global)
    y = launch.result_array(pool.run(driver.spmv_global, tp, x))
    mesh = j_row_mesh(N)
    jpd = jdrv.put_partitioned(jp, mesh)
    yj = _jx(jdrv.make_dist_spmv(jpd, mesh)(_jvec(x, jp, mesh,
                                                   JDT[dtype])))
    xs = x.astype(np.float32).astype(np.float64) if dtype == "float32" \
        else x
    from mpi_bicgstab_tpu_torch.models.problem import pad_csr_identity
    ref = pad_csr_identity(t, 8 * N).matvec(xs)
    scale = np.abs(ref).max()
    assert np.abs(y - yj).max() <= TOL[dtype] * scale
    assert np.abs(y - ref).max() <= TOL[dtype] * scale


@pytest.mark.parametrize("dtype", ["float64", "df32"])
def test_ring_equals_allgather(pool, dtype):
    t, _ = _both("random_diag_dominant", 500, 7, seed=2)
    tp = partition_csr(t, 4, dtype=dtype, format="ell", width=4)
    assert tp.diag_tail_rows.shape[0] + tp.offd_tail_rows.shape[0] > 0
    x = np.random.default_rng(4).standard_normal(tp.n_global)
    ya = launch.result_array(pool.run(driver.spmv_global, tp, x))
    yr = launch.result_array(pool.run(driver.spmv_global, tp, x,
                                      halo="ring"))
    np.testing.assert_allclose(yr, ya, rtol=0, atol=1e-13 * np.abs(ya).max())


def _classic_pair(pool, method, dtype, N, t, j, tol, max_iter=600,
                  restarts=2, fmt="auto", **kw):
    b = t.matvec(np.ones(t.nrows))
    tp = partition_csr(t, N, dtype=dtype, format=fmt)
    jp = j_partition(j, N, dtype=JDT[dtype], format=fmt)
    cdt = "float32" if dtype == "df32" else dtype
    r = pool.run(driver.solve_distributed, tp, b, method=method,
                 cfg=SolverConfig(tol=tol, max_iter=max_iter, dtype=cdt,
                                  restarts=restarts), **kw)
    jkw = {k: JCheby(v.degree, v.lo, v.hi) if k == "precond" else v
           for k, v in kw.items()}
    rj = jdrv.solve_distributed(
        jp, b, method=method, mesh=j_row_mesh(N),
        cfg=JConfig(tol=tol, max_iter=max_iter, dtype=jnp.dtype(cdt),
                    restarts=restarts), **jkw)
    return r, rj


@pytest.mark.parametrize("N", [2, 4])
@pytest.mark.parametrize("method", ["bicgstab", "ca_bicgstab",
                                    "pipe_bicgstab", "pipe_bicgstab_rr",
                                    "bicgstab_l2"])
def test_classic_family_f64_matches_jax(pool, method, N):
    t, j = _both("banded_random", 264, [1, -1, 12, -12], seed=6)
    r, rj = _classic_pair(pool, method, "float64", N, t, j, 1e-10)
    assert bool(r.converged) and bool(rj.converged)
    k, kj = int(r.n_iter), int(rj.n_iter)
    assert abs(k - kj) <= 2
    # the early trajectory, before the reduction orders' rounding paths
    # diverge: the bar JAX holds itself to (tests/test_bicgstab.py:47-57)
    m = min(k, kj, 10)
    h, hj = np.asarray(r.history)[:m], np.asarray(rj.history)[:m]
    ok = ~np.isnan(hj)
    np.testing.assert_allclose(h[ok], hj[ok], rtol=1e-6)
    assert np.abs(r.x[:t.nrows] - 1.0).max() < 1e-7
    np.testing.assert_allclose(r.x[:t.nrows], _jx(rj.x)[:t.nrows],
                               rtol=0, atol=1e-8)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("df32", 1e-10)])
@pytest.mark.parametrize("method", ["bicgstab", "pipe_bicgstab"])
def test_classic_f32_df32_match_jax(pool, method, dtype, tol):
    t, j = _both("banded_random", 264, [1, -1, 12, -12], seed=6)
    r, rj = _classic_pair(pool, method, dtype, 2, t, j, tol)
    assert bool(r.converged) and bool(rj.converged)
    assert abs(int(r.n_iter) - int(rj.n_iter)) <= 2
    x = launch.result_array(r.x)[:t.nrows]
    assert np.abs(x - 1.0).max() < (1e-3 if dtype == "float32" else 1e-8)


def test_restart_rescues_gate_failure(pool):
    # the restart fixture of tests/test_torch_solve.py, over 2 ranks: a
    # float32 solve asked for more than float32 attains fails the true-
    # residual gate, and the refinement restarts rescue it as in JAX
    t, j = _both("banded_random", 4000, [1, -1, 60, -60], seed=9)
    r0, rj0 = _classic_pair(pool, "bicgstab", "float32", 2, t, j, 1e-9,
                            max_iter=300, restarts=0)
    assert not bool(r0.converged) and not bool(rj0.converged)
    assert abs(int(r0.n_iter) - int(rj0.n_iter)) <= 2
    r, rj = _classic_pair(pool, "bicgstab", "float32", 2, t, j, 1e-9,
                          max_iter=300)
    assert bool(r.converged) and bool(rj.converged)
    assert int(r.n_iter) > int(r0.n_iter)       # a restart segment ran
    assert abs(int(r.n_iter) - int(rj.n_iter)) <= 6   # +-2 per segment
    assert float(r.true_relres) <= 100 * 1e-9


def test_cheby_precond_matches_jax(pool):
    t, j = _both("transport_hard", 2048)
    from mpi_bicgstab_tpu_torch.ops.cheby import estimate_bounds
    lo, hi = estimate_bounds(t)
    prec = ChebyPrecond(8, lo, hi)
    r, rj = _classic_pair(pool, "bicgstab", "float64", 2, t, j, 1e-10,
                          max_iter=3000, precond=prec)
    r0, _ = _classic_pair(pool, "bicgstab", "float64", 2, t, j, 1e-10,
                          max_iter=3000)
    assert bool(r.converged) and bool(rj.converged)
    assert abs(int(r.n_iter) - int(rj.n_iter)) <= 2
    assert int(r.n_iter) * 4 <= int(r0.n_iter)
    np.testing.assert_allclose(r.x[:t.nrows], _jx(rj.x)[:t.nrows],
                               rtol=0, atol=1e-8)


def test_batched_lane_restarts_match_jax(pool):
    # the batched form of the restart fixture: both lanes fail the gate
    # without restarts and are rescued lane by lane with them
    t, j = _both("banded_random", 4000, [1, -1, 60, -60], seed=9)
    b = t.matvec(np.ones(t.nrows))
    B = np.stack([b, 2.0 * b])
    tp = partition_csr(t, 2, dtype="float32")
    jp = j_partition(j, 2, dtype=np.dtype(np.float32))
    out = {}
    for restarts in (0, 2):
        r = pool.run(driver.solve_batched_distributed, tp, B,
                     cfg=SolverConfig(tol=1e-9, max_iter=300,
                                      dtype="float32", restarts=restarts))
        rj = jdrv.solve_batched_distributed(
            jp, B, mesh=j_row_mesh(2),
            cfg=JConfig(tol=1e-9, max_iter=300, dtype=jnp.float32,
                        restarts=restarts))
        np.testing.assert_array_equal(np.asarray(r.converged),
                                      np.asarray(rj.converged))
        assert np.abs(np.asarray(r.n_iter) - np.asarray(rj.n_iter)).max() \
            <= 2 * (1 + restarts)
        out[restarts] = r
    assert not out[0].converged.any() and out[2].converged.all()
    assert out[2].x.shape == (2, tp.n_global)
    assert np.abs(out[2].x[1][:t.nrows] - 2.0).max() < 1e-3


def test_refusals_match_jax(pool):
    t, j = _both("poisson2d", 8)
    b = t.matvec(np.ones(64))
    tp, jp = partition_csr(t, 4), j_partition(j, 4)
    # a grid of another size (the JAX message)
    mesh8 = Mesh(8, 1, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="partitioned for"):
        driver.solve_distributed(tp, b, mesh=mesh8)
    with pytest.raises(ValueError, match="partitioned for"):
        jdrv.solve_distributed(jp, b, mesh=j_row_mesh(8))
    # more devices than ranks
    with pytest.raises(RuntimeError, match="requested 8 devices, only 4"):
        pool.run(driver.solve_distributed, partition_csr(t, 8), b)
    with pytest.raises(RuntimeError, match="unknown halo strategy"):
        pool.run(driver.solve_distributed, tp, b, halo="tree")
    with pytest.raises(ValueError, match="unknown halo strategy"):
        jdrv.solve_distributed(jp, b, halo="tree")
    for fn in (driver.solve_distributed, jdrv.solve_distributed):
        with pytest.raises(ValueError, match="unknown method"):
            fn(tp if fn is driver.solve_distributed else jp, b,
               method="gmres")
    # precond needs its bounds; a shifted solve takes none
    with pytest.raises(ValueError, match="bounds"):
        driver.solve_distributed(tp, b, precond=ChebyPrecond(4))
    for fn, p in ((driver.solve_shifted_distributed, tp),
                  (jdrv.solve_shifted_distributed, jp)):
        with pytest.raises(TypeError):
            fn(p, b, np.array([0.0, 0.1]), precond=ChebyPrecond(4, 1, 2))


@pytest.mark.parametrize("dtype", ["float64", "float32", "df32"])
def test_dia_halo_twin_equals_the_global_rows(dtype):
    """The halo form's twin on a rank's band rows over its halo-extended
    slice (neighbour rows inside, zeros past the matrix) gives the
    global SpMV's rows: the float twins to rounding, the DF twin equal to
    the DF SpMV of the whole band, bit for bit."""
    from mpi_bicgstab_tpu_torch.ops import cuda_spmv
    from mpi_bicgstab_tpu_torch.ops.dia import csr_to_dia
    from mpi_bicgstab_tpu_torch.ops.precision import df_from_f64, df_to_f64
    t, _ = _both("banded_random", 1000, [1, -1, 9, -9, 200], seed=0)
    offs = (-9, -1, 0, 1, 9, 200)
    A, _ = csr_to_dia(t, offs, dtype=dtype, device="cpu")
    x = np.random.default_rng(0).standard_normal(1000)
    halo, s, e = 256, 300, 700
    xh = np.zeros(e - s + 2 * halo)
    xh[:] = np.pad(x, halo)[s:e + 2 * halo]
    if dtype == "df32":
        sl = A.vals[:, s:e]
        got = df_to_f64(cuda_spmv.dia_spmv_df_plain(
            type(sl)(sl.hi.contiguous(), sl.lo.contiguous()), offs,
            df_from_f64(xh), halo=halo))
        full = df_to_f64(cuda_spmv.dia_spmv_df_plain(A.vals, offs,
                                                     df_from_f64(x)))
        np.testing.assert_array_equal(got, full[s:e])
        return
    dt = torch.float64 if dtype == "float64" else torch.float32
    got = cuda_spmv.dia_spmv_plain(A.vals[:, s:e], offs,
                                   torch.as_tensor(xh, dtype=dt),
                                   halo=halo).double().numpy()
    want = t.matvec(x.astype(np.float32).astype(np.float64)
                    if dtype == "float32" else x)[s:e]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL[dtype] * np.abs(want).max())
