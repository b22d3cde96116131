"""The blocked distributed batch (solvers/batched_dist.py, parallel/
driver.solve_batched_distributed), the port's counterpart of the JAX
package's vmapped lanes inside shard_map, on the CPU with gloo ranks:

* the halo forms of the batched kernels' plain twins (kernel 19's SpMV,
  K1b and K2b with their stage 0 over the halo rows, and K3b on the
  rank's rows) on each of three ranks' rows equal the global twin's rows
  bit for bit, frozen lanes included and NaN in the halo a rank may not
  read; the ranks' dots sum to the global dots;
* the blocked batch (k = 3: float32 on a DIA halo partition, the fused
  route; float64 on ELL, the blocked unfused loop; df32 lane by lane)
  against the JAX package's solve_batched_distributed at 2 and 4
  devices: per-lane n_iter within 2 and the same converged flags, with
  and without lane restarts;
* on one rank the fused route is the single-device
  bicgstab_batched_fully_fused bit for bit;
* a solve makes 3 reductions per iteration for all lanes, not 3 k
  (parallel/comm.counted).

One module-scoped pool of 4 ranks runs every port solve."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_bicgstab_tpu.models import generators as jgen
from mpi_bicgstab_tpu.parallel import driver as jdrv
from mpi_bicgstab_tpu.parallel.mesh import make_row_mesh as j_row_mesh
from mpi_bicgstab_tpu.parallel.partition import partition_csr as j_partition
from mpi_bicgstab_tpu.utils.config import SolverConfig as JConfig
from mpi_bicgstab_tpu_torch.models import generators as tgen
from mpi_bicgstab_tpu_torch.models.problem import build_problem
from mpi_bicgstab_tpu_torch.ops import cuda_batched_spmv as cbs
from mpi_bicgstab_tpu_torch.ops import cuda_fused_batched as fb
from mpi_bicgstab_tpu_torch.ops.cuda_spmv import Halo
from mpi_bicgstab_tpu_torch.ops.dia import analyze_diagonals, csr_to_dia
from mpi_bicgstab_tpu_torch.parallel import comm, driver, launch
from mpi_bicgstab_tpu_torch.parallel.partition import partition_csr
from mpi_bicgstab_tpu_torch.solvers.batched_fused import \
    bicgstab_batched_fully_fused
from mpi_bicgstab_tpu_torch.utils.config import SolverConfig

torch.set_num_threads(1)
F32 = torch.float32


@pytest.fixture(scope="module")
def pool():
    with launch.Pool(4, device="cpu") as p:
        yield p


# --- the twins' halo forms against the global rows ------------------------

N_ROWS, RANKS, K = 600, 3, 4


def _ext(P, s, e, h, prev, nxt):
    """Columns [s, e) of the global [k, N] plane P with h columns each
    side: the neighbours' rows where the rank has neighbours, NaN where
    it has none (a halo the kernels never read)."""
    k = P.shape[0]
    lo = P[:, s - h:s] if prev else torch.full((k, h), float("nan"))
    hi = P[:, e:e + h] if nxt else torch.full((k, h), float("nan"))
    return torch.cat([lo, P[:, s:e], hi], 1)


# pass: (twin, planes it takes, its args, outputs whose halo rows stage 0
# writes, plane outputs, dot outputs)
PASSES = {
    "fused_k1b": (fb.fused_k1b_plain, 4,
                  lambda v, V, S, o: (v, *V, (S["beta"], S["omega"],
                                              S["active"]), o), (0,), 2, 1),
    "fused_k2b": (fb.fused_k2b_plain, 2,
                  lambda v, V, S, o: (v, *V, (S["alpha"],), o), (0,), 2, 2),
    "fused_k3b": (fb.fused_k3b_plain, 5,
                  lambda v, V, S, o: (*V, (S["alpha"], S["omega"],
                                           S["active"])), (), 2, 2),
}


def _lane_scalars():
    g = np.random.default_rng(9)
    S = {k: torch.as_tensor(g.uniform(0.1, 0.9, K), dtype=F32)
         for k in ("alpha", "beta", "omega")}
    S["active"] = torch.tensor([1.0, 0.0, 1.0, 1.0])    # lane 1 frozen
    return S


@pytest.mark.parametrize("h", [40, 64])
@pytest.mark.parametrize("name", [*PASSES, "batched_dia_spmv"])
def test_batched_halo_twins_equal_the_global_rows(name, h):
    csr = tgen.banded_random(N_ROWS, [1, -1, 12, -12, 40, -40], seed=2)
    offsets, _ = analyze_diagonals(csr)
    A, _ = csr_to_dia(csr, offsets, dtype=F32, device="cpu")
    g = np.random.default_rng(4)
    if name == "batched_dia_spmv":
        twin, n_in, args, whole, n_vec, n_dot = (
            lambda v, X, o, halo=None: (cbs.batched_dia_spmv_plain(
                v, o, X, halo),), 1, lambda v, V, S, o: (v, *V, o), (), 1, 0)
    else:
        twin, n_in, args, whole, n_vec, n_dot = PASSES[name]
    planes = [torch.as_tensor(g.standard_normal((K, N_ROWS)), dtype=F32)
              for _ in range(n_in)]
    S = _lane_scalars()
    want = twin(*args(A.vals, planes, S, A.offsets))
    n_loc = N_ROWS // RANKS
    dots = []
    for r in range(RANKS):
        s, e = r * n_loc, (r + 1) * n_loc
        prev, nxt = r > 0, r < RANKS - 1
        halo = Halo(h, prev, nxt)
        lo, hi = halo.bounds(n_loc)
        got = twin(*args(A.vals[:, s:e].contiguous(),
                         [_ext(P, s, e, h, prev, nxt) for P in planes], S,
                         A.offsets), halo=halo)
        for k in range(n_vec):
            g_ = got[k] if got[k].shape[1] == n_loc \
                else got[k][:, h:h + n_loc]
            assert torch.equal(g_, want[k][:, s:e]), (name, r, k)
            if k in whole:     # stage 0's halo rows: the global rows
                assert torch.equal(got[k][:, h + lo:h + hi],
                                   want[k][:, s + lo:s + hi]), (name, r, k)
        dots.append(got[n_vec:n_vec + n_dot])
    for k in range(n_dot):
        total = sum(d[k].double() for d in dots)
        np.testing.assert_allclose(total.numpy(),
                                   want[n_vec + k].double().numpy(),
                                   rtol=1e-4, atol=1e-3)


# --- distributed batched solves -------------------------------------------

def _pair(n=1200):
    t = tgen.banded_random(n, [1, -1, 12, -12, 40, -40], seed=6)
    j = jgen.banded_random(n, [1, -1, 12, -12, 40, -40], seed=6)
    np.testing.assert_array_equal(t.val, j.val)
    g = np.random.default_rng(11)
    X = np.vstack([np.ones(n), g.standard_normal((2, n))])
    return t, j, np.stack([t.matvec(x) for x in X])


# (dtype, format, tol, restarts): the fused route, the blocked unfused
# loop on ELL, df32 lane by lane; float32 at 1e-9 makes every lane restart
CASES = [("float32", "auto", 1e-5, 2), ("float32", "auto", 1e-9, 2),
         ("float64", "ell", 1e-10, 2), ("df32", "auto", 1e-10, 2)]


@pytest.mark.parametrize("N", [2, 4])
@pytest.mark.parametrize("dtype,fmt,tol,restarts", CASES)
def test_blocked_batch_matches_jax(pool, dtype, fmt, tol, restarts, N):
    t, j, B = _pair()
    cfg = dict(tol=tol, max_iter=400, restarts=restarts)
    part = partition_csr(t, N, dtype=dtype, format=fmt)
    assert (part.dia_mode == "halo") == (fmt == "auto")
    r = pool.run(driver.solve_batched_distributed, part, B,
                 cfg=SolverConfig(dtype="float32" if dtype == "df32"
                                  else dtype, **cfg))
    jd = "df32" if dtype == "df32" else np.dtype(dtype)
    rj = jdrv.solve_batched_distributed(
        j_partition(j, N, dtype=jd, format=fmt), B, mesh=j_row_mesh(N),
        cfg=JConfig(dtype=jnp.float32 if dtype == "df32"
                    else jnp.dtype(dtype), **cfg))
    its, jts = np.asarray(r.n_iter), np.asarray(rj.n_iter)
    assert np.abs(its - jts).max() <= 2, (its, jts)
    np.testing.assert_array_equal(np.asarray(r.converged),
                                  np.asarray(rj.converged))
    assert np.asarray(r.converged).all()
    x = launch.result_array(r.x)[:, :t.nrows]
    assert np.abs(x[0] - 1.0).max() < (1e-2 if dtype == "float32"
                                       else 1e-8)


def test_one_rank_is_the_single_device_batch(pool):
    t, _, B = _pair()
    cfg = SolverConfig(tol=1e-5, max_iter=400, dtype="float32")
    r = pool.run(driver.solve_batched_distributed,
                 partition_csr(t, 1, dtype="float32"), B, cfg=cfg)
    prob = build_problem(t, dtype=F32, multiple=1, device="cpu")
    Bt = torch.as_tensor(B, dtype=F32)
    single = bicgstab_batched_fully_fused(prob.A, Bt, torch.zeros_like(Bt),
                                          cfg)
    np.testing.assert_array_equal(np.asarray(r.n_iter),
                                  single.n_iter.numpy())
    np.testing.assert_array_equal(r.history, single.history.numpy())
    np.testing.assert_array_equal(r.x[:, :t.nrows], single.x.numpy())


@pytest.mark.parametrize("dtype,fmt", [("float32", "auto"),
                                       ("float64", "ell")])
def test_one_reduction_per_point_for_all_lanes(pool, dtype, fmt):
    """3 collectives per iteration for the k = 3 lanes, plus r0's, the
    exit's and the gather of X (restarts off); the blocked ELL loop's
    SpMVs gather the iterate once per lane and SpMV besides."""
    t, _, B = _pair()
    part = partition_csr(t, 2, dtype=dtype, format=fmt)
    cfg = SolverConfig(tol=1e-5, max_iter=400, dtype=dtype, restarts=0)
    res, issued = pool.run(comm.counted, driver.solve_batched_distributed,
                           part, B, cfg=cfg)
    it = int(np.max(res.n_iter))
    spmv_gathers = 0 if fmt == "auto" else 3 * (2 * it + 2)
    assert issued == 3 * it + 3 + spmv_gathers
