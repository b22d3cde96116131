"""Port vs JAX package: the shifted family (solvers/shifted.py), the
per-shift refinement (solvers/refine.py) and the pieces they stand on
(ShiftedConfig, the shift-ladder row helpers, build_problem's sigma_seed,
the vabs / vbroadcast_rows / vcat helpers).

The same generator inputs go through both packages' solve_shifted on the
CPU, in float64 and df32, on the JAX package's own ladder of
tests/test_shifted.py (SIGMA5, banded_random(120), seed 2). Tolerances:
n_iter within +-2, stop flags and final seed equal, shift_relres within
rtol 1e-6 in float64 where n_iter is equal, solutions within 1e-8, and
every shift's TRUE residual ||b - (A + sigma_j I) x_j|| / ||b|| at most
100 tol.
"""
import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.api as japi
import mpi_bicgstab_tpu.models.generators as jgen
import mpi_bicgstab_tpu.models.problem as jprob
import mpi_bicgstab_tpu.ops.precision as jp
import mpi_bicgstab_tpu.utils.config as jcfg
import mpi_bicgstab_tpu_torch.api as tapi
import mpi_bicgstab_tpu_torch.models.generators as tgen
import mpi_bicgstab_tpu_torch.models.problem as tprob
import mpi_bicgstab_tpu_torch.ops.precision as tp
from mpi_bicgstab_tpu_torch import convert
from mpi_bicgstab_tpu_torch.parallel import sigma as tsig
from mpi_bicgstab_tpu_torch.solvers import shifted as tsh
from mpi_bicgstab_tpu_torch.utils.config import ShiftedConfig, SolverConfig

torch.set_num_threads(1)

SIGMA5 = np.array([0.0, 0.01, 0.02, 0.03, 0.04])
N, OFFSETS, GEN_SEED = 120, [1, -1, 10, -10], 11
TOL = 1e-10
METHODS = ["shifted_bicgstab", "shifted_lopbicgstab",
           "shifted_pipe_lopbicgstab"]


def _x(x):
    return tp.df_to_f64(x) if tp.is_df(x) else x.double().numpy()


def _jx(x):
    return jp.df_to_f64(x) if jp.is_df(x) else np.asarray(x, np.float64)


def _problems(dtype, sigma_seed=0.0):
    csr = tgen.banded_random(N, OFFSETS, seed=GEN_SEED)
    pj = jprob.build_problem(jgen.banded_random(N, OFFSETS, seed=GEN_SEED),
                             dtype=dtype, sigma_seed=sigma_seed)
    pt = tprob.build_problem(csr, dtype=dtype, multiple=1, device="cpu",
                             sigma_seed=sigma_seed)
    return csr, pj, pt


def _jcfg(dtype, **kw):
    return jcfg.ShiftedConfig(dtype="df32" if dtype == "df32"
                              else np.float64, **kw)


def true_residuals(csr, sigma, x_set, sigma_seed=0.0):
    b = csr.matvec(np.ones(csr.nrows)) + sigma_seed
    return np.array([np.linalg.norm(csr.matvec(x) + s * x - b)
                     / np.linalg.norm(b) for s, x in zip(sigma, x_set)])


def compare(rj, rt, csr, sigma, dtype, tol, sigma_seed=0.0):
    """The port's ShiftedResult against the JAX package's (module doc)."""
    assert abs(rt.n_iter - int(rj.n_iter)) <= 2, (rt.n_iter, rj.n_iter)
    assert rt.final_seed == int(rj.final_seed)
    np.testing.assert_array_equal(rt.stop_flags.numpy(),
                                  np.asarray(rj.stop_flags))
    if dtype == "float64" and rt.n_iter == int(rj.n_iter):
        np.testing.assert_allclose(rt.shift_relres.numpy(),
                                   np.asarray(rj.shift_relres), rtol=1e-6)
    xt = _x(rt.x_set)
    np.testing.assert_allclose(xt, _jx(rj.x_set)[:, :csr.nrows], atol=1e-8)
    res = true_residuals(csr, sigma, xt, sigma_seed)
    assert res.max() <= 100 * tol, res


@pytest.mark.parametrize("dtype", ["float64", "df32"])
@pytest.mark.parametrize("method", METHODS)
def test_shifted_method_matches_jax(method, dtype):
    csr, pj, pt = _problems(dtype)
    rj = japi.solve_shifted(pj.A, pj.b, SIGMA5, seed=2, method=method,
                            cfg=_jcfg(dtype, tol=TOL, max_iter=400))
    rt = tapi.solve_shifted(pt.A, pt.b, SIGMA5, seed=2, method=method,
                            cfg=ShiftedConfig(tol=TOL, max_iter=400,
                                              dtype=dtype))
    assert bool(rt.stop_flags.all())
    compare(rj, rt, csr, SIGMA5, dtype, TOL)
    assert tp.is_df(rt.x_set) == (dtype == "df32")
    assert rt.history.shape == (400,)
    assert float(rt.true_relres) <= 100 * TOL


def test_aliases_and_the_solver_table():
    s = tsh.SHIFTED_SOLVERS
    assert s["shifted_lopbicgstab_v2"] is tsh.shifted_lopbicgstab
    assert s["shifted_lopbicgstab_nooverlap"] is tsh.shifted_lopbicgstab
    assert s["shifted_pipe_lopbicgstab_nooverlap"] is \
        tsh.shifted_pipe_lopbicgstab
    assert set(tapi._all_shifted_solvers()) == set(japi._all_shifted_solvers())


@pytest.mark.parametrize("method", METHODS + ["shifted_lopbicg",
                                              "shifted_lopbicg_switching"])
def test_tol0_runs_exactly_max_iter(method):
    _, _, pt = _problems("float64")
    res = tapi.solve_shifted(pt.A, pt.b, SIGMA5, seed=2, method=method,
                             cfg=ShiftedConfig(tol=0.0, max_iter=7))
    assert res.n_iter == 7
    assert int(torch.isnan(res.history).sum()) == 0


def test_bad_inputs_raise():
    _, _, pt = _problems("float64")
    with pytest.raises(ValueError, match="out of range"):
        tapi.solve_shifted(pt.A, pt.b, SIGMA5, seed=5)
    with pytest.raises(ValueError, match="unknown method"):
        tapi.solve_shifted(pt.A, pt.b, SIGMA5, method="shifted_nope")


def test_shifted_config_mirrors_jax():
    want = jcfg.ShiftedConfig()
    got = ShiftedConfig()
    for f in ("tol", "max_iter", "out_iter", "verbose_switch",
              "shift_block"):
        assert getattr(got, f) == getattr(want, f), f
    # the JAX field that does nothing here is not carried; the
    # distributed no-overlap mode is
    assert not hasattr(got, "record_history")
    assert got.serialize_comm is want.serialize_comm is False
    assert got.dtype == torch.float64
    assert ShiftedConfig(dtype="df32").dtype == torch.float32
    assert ShiftedConfig(dtype=np.float32).replace(tol=0.5).tol == 0.5
    import dataclasses
    fields = dataclasses.asdict(jcfg.ShiftedConfig(tol=1e-9, max_iter=77,
                                                   dtype="df32",
                                                   shift_block=4))
    carried = convert.shifted_config_from_fields(fields)
    assert (carried.tol, carried.max_iter, carried.dtype,
            carried.shift_block) == (1e-9, 77, torch.float32, 4)
    assert convert.shifted_config_from_fields(dataclasses.asdict(
        jcfg.ShiftedConfig(serialize_comm=True))).serialize_comm is True


def test_sigma_row_helpers():
    slab = torch.arange(12.0).reshape(3, 4)
    row = tsig.take_row(slab, 1)
    assert tsig.row_add(slab, 1, torch.ones(4)) is slab    # in place
    assert torch.equal(row, torch.arange(4.0, 8.0))      # a copy
    assert torch.equal(slab[1], torch.arange(5.0, 9.0))
    tsig.row_set(slab, 0, torch.zeros(4))
    assert float(slab[0].abs().sum()) == 0.0
    mask = torch.tensor([True, False, True])
    col = tsig.coeff(mask, torch.tensor([2.0, 3.0, 4.0]), 1.0)
    assert col.shape == (3, 1) and col[:, 0].tolist() == [2.0, 1.0, 4.0]
    dslab = tp.df_from_f64(np.arange(12.0).reshape(3, 4))
    drow = tsig.take_row(dslab, 2)
    tsig.row_add(dslab, 2, tp.df_from_f64(np.full(4, 0.5)))
    np.testing.assert_array_equal(tp.df_to_f64(drow), np.arange(8.0, 12.0))
    np.testing.assert_array_equal(tp.df_to_f64(dslab)[2],
                                  np.arange(8.0, 12.0) + 0.5)


def test_build_problem_sigma_seed_matches_jax():
    for dtype in ("float64", "df32"):
        _, pj, pt = _problems(dtype, sigma_seed=0.37)
        np.testing.assert_allclose(_x(pt.b), _jx(pj.b), rtol=1e-15)


def test_vector_helpers_match_jax():
    rng = np.random.default_rng(3)
    a = rng.standard_normal(6) * 1e3
    jd, td = jp.df_from_f64(a), tp.df_from_f64(a)
    np.testing.assert_array_equal(tp.df_to_f64(tp.vabs(td)),
                                  jp.df_to_f64(jp.vabs(jd)))
    assert torch.equal(tp.vabs(torch.tensor(a)), torch.tensor(np.abs(a)))
    rows = tp.vbroadcast_rows(td, 3)
    np.testing.assert_array_equal(tp.df_to_f64(rows),
                                  jp.df_to_f64(jp.vbroadcast_rows(jd, 3)))
    rows.hi[0, 0] = 7.0                    # a materialised copy
    assert float(td.hi[0]) != 7.0
    cat = tp.vcat([td, torch.ones(2, dtype=torch.float32)])
    np.testing.assert_array_equal(
        tp.df_to_f64(cat),
        jp.df_to_f64(jp.vcat([jd, np.ones(2, np.float32)])))
    assert torch.equal(tp.vcat([torch.ones(2), torch.zeros(1)]),
                       torch.tensor([1.0, 1.0, 0.0]))


@pytest.mark.parametrize("dtype", ["float64", "df32"])
def test_refine_matches_jax(dtype):
    """A loose shifted solve (tol 1e-4) polished to 1e-10 by the batched
    per-shift BiCGStab, in both packages: the same number of refinement
    iterations (within 2), every row's relres <= tol, solutions within
    1e-8, the true residuals at most 100 tol."""
    csr, pj, pt = _problems(dtype)
    loose = dict(tol=1e-4, max_iter=400)
    rj = japi.solve_shifted(pj.A, pj.b, SIGMA5, seed=2,
                            method="shifted_lopbicg",
                            cfg=_jcfg(dtype, **loose))
    rt = tapi.solve_shifted(pt.A, pt.b, SIGMA5, seed=2,
                            method="shifted_lopbicg",
                            cfg=ShiftedConfig(dtype=dtype, **loose))
    jrc = jcfg.SolverConfig(tol=TOL, max_iter=200,
                            dtype=np.float32 if dtype == "df32"
                            else np.float64)
    xj, kj, rrj = japi.refine_shifted_solutions(pj.A, pj.b, SIGMA5,
                                                rj.x_set, jrc)
    xt, kt, rrt = tapi.refine_shifted_solutions(
        pt.A, pt.b, SIGMA5, rt.x_set,
        SolverConfig(tol=TOL, max_iter=200, dtype=dtype), chunk=2)
    assert abs(kt - int(kj)) <= 2 and kt > 0
    assert rrt.shape == (5,) and float(rrt.max()) <= TOL
    np.testing.assert_allclose(_x(xt), _jx(xj)[:, :N], atol=1e-8)
    assert true_residuals(csr, SIGMA5, _x(xt)).max() <= 100 * TOL
