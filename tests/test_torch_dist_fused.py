"""The halo-fused distributed route (mpi_bicgstab_tpu_torch/solvers/
fused_dist.py), the port's counterpart of the JAX package's
solvers/fused_dist.py, on the CPU:

* the halo forms of the ten fused passes' plain twins (ops/cuda_spmv.Halo)
  on each of three ranks' rows equal the global twin's rows bit for bit,
  NaN in the halo a rank may not read included, and the ranks' dots sum to
  the global dots;
* solve_distributed on a gloo group of 2 and 4 ranks takes the route for
  float32 classic, CA, pipelined and pipelined-RR and df32 classic, and
  agrees with the JAX package's solve_distributed at the same device
  count (n_iter within 2; the JAX package takes its unfused XLA path on
  the CPU, as its fused gate is TPU-only there);
* on one rank the route is the single-device fused driver bit for bit;
* the dispatch gate against the JAX gate's conditions.

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
from mpi_bicgstab_tpu_torch import api
from mpi_bicgstab_tpu_torch.models import generators as tgen
from mpi_bicgstab_tpu_torch.models.problem import build_problem
from mpi_bicgstab_tpu_torch.ops import cuda_fused_ca as fca
from mpi_bicgstab_tpu_torch.ops import cuda_fused_classic as fcl
from mpi_bicgstab_tpu_torch.ops import cuda_fused_classic_df as fcldf
from mpi_bicgstab_tpu_torch.ops import cuda_fused_pipe as fpipe
from mpi_bicgstab_tpu_torch.ops.cuda_spmv import Halo, center
from mpi_bicgstab_tpu_torch.ops.dia import analyze_diagonals, csr_to_dia
from mpi_bicgstab_tpu_torch.ops.precision import DF, df_from_f64, is_df
from mpi_bicgstab_tpu_torch.parallel import driver, launch
from mpi_bicgstab_tpu_torch.parallel.partition import partition_csr
from mpi_bicgstab_tpu_torch.solvers import fused_dist
from mpi_bicgstab_tpu_torch.utils.config import SolverConfig

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pool():
    with launch.Pool(4, device="cpu") as p:
        yield p


# --- the twins' halo forms against the global rows ------------------------

N_ROWS, RANKS = 600, 3
F32 = torch.float32


def _scalars(df):
    mk = (lambda v: df_from_f64(np.float64(v) * (1 + 1e-9), "cpu")) if df \
        else (lambda v: torch.tensor(v, dtype=F32))
    return {k: mk(v) for k, v in (("alpha", 0.7), ("beta", 0.3),
                                  ("omega", 0.2), ("rTr", 2.5))}


# pass: (twin, DF?, vectors it takes, its args from (vals, vecs, scalars,
# offsets), vector outputs, dot outputs)
PASSES = {
    "fused_k1": (fcl.fused_k1_plain, False, 4,
                 lambda v, V, S, o: (v, *V, (S["beta"], S["omega"]), o), 2, 1),
    "fused_k2": (fcl.fused_k2_plain, False, 2,
                 lambda v, V, S, o: (v, *V, (S["alpha"],), o), 2, 2),
    "fused_k3": (fcl.fused_k3_plain, False, 5,
                 lambda v, V, S, o: (*V, (S["alpha"], S["omega"])), 2, 2),
    "fused_ca_k1": (fca.fused_ca_k1_plain, False, 5,
                    lambda v, V, S, o: (v, *V, (S["alpha"], S["beta"],
                                                S["omega"]), o), 5, 2),
    "fused_ca_k2": (fca.fused_ca_k2_plain, False, 7,
                    lambda v, V, S, o: (v, *V, (S["alpha"], S["omega"]), o),
                    3, 5),
    "fused_phase_a": (fpipe.fused_phase_a_plain, False, 6,
                      lambda v, V, S, o: (v, *V, (S["alpha"], S["beta"],
                                                  S["omega"]), o), 5, 2),
    "fused_phase_b": (fpipe.fused_phase_b_plain, False, 8,
                      lambda v, V, S, o: (v, *V, (S["alpha"], S["omega"]),
                                          o), 3, 5),
    "fused_k1_df": (fcldf.fused_k1_df_plain, True, 4,
                    lambda v, V, S, o: (v, *V, (S["beta"], S["omega"],
                                                S["rTr"]), o), 2, 1),
    "fused_k2_df": (fcldf.fused_k2_df_plain, True, 2,
                    lambda v, V, S, o: (v, *V, (S["alpha"],), o), 2, 2),
    "fused_k3_df": (fcldf.fused_k3_df_plain, True, 5,
                    lambda v, V, S, o: (*V, (S["alpha"], S["omega"],
                                             S["rTr"])), 2, 2),
}


def _halves(v):
    return (v.hi, v.lo) if is_df(v) else (v,)


def _rows(v, s, e):
    return DF(v.hi[s:e], v.lo[s:e]) if is_df(v) else v[s:e]


def _ext(v, s, e, h, prev, nxt):
    """Rows [s, e) of the global vector v with h entries each side: the
    neighbours' rows where the rank has neighbours, NaN where it has
    none (a halo the kernels never read)."""
    out = []
    for t in _halves(v):
        lo = t[s - h:s] if prev else torch.full((h,), float("nan"))
        hi = t[e:e + h] if nxt else torch.full((h,), float("nan"))
        out.append(torch.cat([lo, t[s:e], hi]))
    return DF(*out) if is_df(v) else out[0]


def _value(d) -> float:
    """A 0-d dot's value (a pair's hi + lo) in float64."""
    return sum(float(t.double()) for t in _halves(d))


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_halves(a), _halves(b)))


@pytest.mark.parametrize("h", [40, 64])
@pytest.mark.parametrize("name", list(PASSES))
def test_halo_twins_equal_the_global_rows(name, h):
    twin, df, n_in, args, n_vec, n_dot = PASSES[name]
    csr = tgen.banded_random(N_ROWS, [1, -1, 12, -12, 40, -40], seed=2)
    offsets, _ = analyze_diagonals(csr)
    A, _ = csr_to_dia(csr, offsets, dtype="df32" if df else F32,
                      device="cpu")
    g = np.random.default_rng(4)
    vecs = [df_from_f64(g.standard_normal(N_ROWS), "cpu") if df else
            torch.as_tensor(g.standard_normal(N_ROWS), dtype=F32)
            for _ in range(n_in)]
    S = _scalars(df)
    want = twin(*args(A.vals, vecs, S, A.offsets))
    n_loc = N_ROWS // RANKS
    dots = []
    for r in range(RANKS):
        s, e = r * n_loc, (r + 1) * n_loc
        halo = Halo(h, r > 0, r < RANKS - 1)
        vals = DF(*(t[:, s:e].contiguous() for t in _halves(A.vals))) \
            if df else A.vals[:, s:e].contiguous()
        got = twin(*args(vals, [_ext(v, s, e, h, r > 0, r < RANKS - 1)
                                for v in vecs], S, A.offsets), halo=halo)
        for k in range(n_vec):
            assert _same(center(got[k], halo), _rows(want[k], s, e)), \
                (name, r, k)
        dots.append(got[n_vec:n_vec + n_dot])
    for k in range(n_dot):
        total = sum(_value(d[k]) for d in dots)
        assert total == pytest.approx(_value(want[n_vec + k]),
                                      rel=1e-10 if df else 1e-4,
                                      abs=1e-8 if df else 1e-3)


# --- distributed solves ---------------------------------------------------

def _pair(name, *args, **kw):
    t, j = getattr(tgen, name)(*args, **kw), getattr(jgen, name)(*args, **kw)
    np.testing.assert_array_equal(t.val, j.val)
    return t, j


ROUTED = [("bicgstab", "float32", 1e-5), ("ca_bicgstab", "float32", 1e-5),
          ("pipe_bicgstab", "float32", 1e-5),
          ("pipe_bicgstab_rr", "float32", 1e-5), ("bicgstab", "df32", 1e-10)]


@pytest.mark.parametrize("N", [2, 4])
@pytest.mark.parametrize("method,dtype,tol", ROUTED)
def test_fused_route_matches_jax(pool, method, dtype, tol, N):
    t, j = _pair("banded_random", 1200, [1, -1, 12, -12, 40, -40], seed=6)
    b = t.matvec(np.ones(t.nrows))
    tp = partition_csr(t, N, dtype=dtype)
    assert tp.dia_mode == "halo"
    cfg = dict(tol=tol, max_iter=400, krr=3, nrr=2)
    r = pool.run(driver.solve_distributed, tp, b, method=method,
                 cfg=SolverConfig(dtype="float32", **cfg))
    rj = jdrv.solve_distributed(
        j_partition(j, N, dtype="df32" if dtype == "df32"
                    else np.dtype(np.float32)), b, method=method,
        mesh=j_row_mesh(N), cfg=JConfig(dtype=jnp.float32, **cfg))
    assert bool(r.converged) and bool(rj.converged)
    assert abs(int(r.n_iter) - int(rj.n_iter)) <= 2
    x = launch.result_array(r.x)[:t.nrows]
    assert np.abs(x - 1.0).max() < (1e-3 if dtype == "float32" else 1e-8)


@pytest.mark.parametrize("method,dtype,tol", ROUTED)
def test_one_rank_is_the_single_device_route(pool, method, dtype, tol):
    t = tgen.banded_random(1200, [1, -1, 12, -12, 40, -40], seed=6)
    b = t.matvec(np.ones(t.nrows))
    cfg = SolverConfig(tol=tol, max_iter=400, dtype="float32", krr=3,
                       nrr=2)
    r = pool.run(driver.solve_distributed, partition_csr(t, 1, dtype=dtype),
                 b, method=method, cfg=cfg)
    prob = build_problem(t, dtype="df32" if dtype == "df32" else F32,
                         multiple=1, device="cpu")
    single = api.solve(prob.A, prob.b, method=method, cfg=cfg)
    assert int(r.n_iter) == int(single.n_iter)
    np.testing.assert_array_equal(np.asarray(r.history),
                                  single.history.numpy())
    np.testing.assert_array_equal(launch.result_array(r.x)[:t.nrows],
                                  launch.result_array(
                                      launch.to_host(single.x)))


def test_route_gate():
    """fused_dist.applicable against the JAX gate's conditions."""
    from mpi_bicgstab_tpu_torch.ops.cheby import ChebyPrecond

    def shard_of(csr, dtype, fmt="auto", N=2):
        return partition_csr(csr, N, dtype=dtype, format=fmt).shard(
            0, torch.device("cpu"))

    band = tgen.banded_random(1200, [1, -1, 12, -12], seed=6)
    f32, df = shard_of(band, "float32"), shard_of(band, "df32")
    b32 = torch.zeros(f32.n_loc)
    bdf = DF(b32, b32.clone())
    cfg = SolverConfig(dtype="float32")
    ok = fused_dist.applicable
    for m in fused_dist.F32_METHODS:
        assert ok(f32, m, b32, cfg)
    assert not ok(f32, "bicgstab_l2", b32, cfg)
    assert ok(df, "bicgstab", bdf, cfg)
    assert not any(ok(df, m, bdf, cfg) for m in
                   ("ca_bicgstab", "pipe_bicgstab", "pipe_bicgstab_rr"))
    f64 = shard_of(band, "float64")
    assert not ok(f64, "bicgstab", torch.zeros(f64.n_loc,
                                               dtype=torch.float64), cfg)
    assert not ok(f32, "bicgstab", b32, cfg, ChebyPrecond(4, 1.0, 2.0))
    assert not ok(f32, "bicgstab", b32, SolverConfig(dtype="float32",
                                                     out_iter=5))
    # a band wider than a shard: gather mode
    wide = tgen.banded_random(400, [1, -1, 150, -150], seed=1)
    g = shard_of(wide, "float32", fmt="dia", N=4)
    assert g.dia_mode == "gather"
    assert not ok(g, "bicgstab", torch.zeros(g.n_loc), cfg)
    # another layout
    e = shard_of(band, "float32", fmt="ell")
    assert not ok(e, "bicgstab", torch.zeros(e.n_loc), cfg)
