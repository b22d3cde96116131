"""Port vs JAX package: the df32 (double-float) CA-BiCGStab path — the
plain twins of the fused DF CA passes K1 and K2, and df32 ca_bicgstab
solves through api.solve.

The twins (what the port's wrappers run for CPU tensors) are held to the
JAX package's XLA expressions for the same quantities (vfma,
dia_spmv_df, df_dot on a JAX DF operator carried across), as
tests/test_fused_pipe.py holds the JAX DF kernels; the JAX DF Pallas
kernels are not run here (in interpret mode they are slow). Tolerances:
vectors rtol = atol = 1e-12, SpMV outputs and what is formed from them
1e-11, dots within 1e-12 sum |u_i v_i|, folded scalars 1e-13 relative of
their formula on the port's own dots. Solves at tol 1e-11 against the
JAX package's api.solve (its unfused XLA route on the CPU): n_iter
within +-2, both converged, max|x-1| < 1e-8.
"""
import functools

import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.api as japi
import mpi_bicgstab_tpu.models.generators as jgen
import mpi_bicgstab_tpu.models.problem as jprob
import mpi_bicgstab_tpu.ops.dia as jdia
import mpi_bicgstab_tpu.ops.precision as jp
import mpi_bicgstab_tpu.utils.config as jcfg
import mpi_bicgstab_tpu_torch.api as tapi
import mpi_bicgstab_tpu_torch.models.generators as tgen
import mpi_bicgstab_tpu_torch.models.problem as tprob
import mpi_bicgstab_tpu_torch.ops.cuda_fused_ca_df as tfca
import mpi_bicgstab_tpu_torch.ops.cuda_spmv as tspmv
import mpi_bicgstab_tpu_torch.ops.layout as tlayout
import mpi_bicgstab_tpu_torch.ops.precision as tp
from mpi_bicgstab_tpu_torch import convert
from mpi_bicgstab_tpu_torch.parallel.comm import Comm
from mpi_bicgstab_tpu_torch.solvers.bicgstab import CLASSIC_SOLVERS
from mpi_bicgstab_tpu_torch.utils.config import SolverConfig

torch.set_num_threads(1)

CASES = {
    "narrow": (4096, [1, -1, 40, -40, 129, -129], 11),
    "wide": (4096, [1, -1, 3000, -3000], 7),       # most rows skip a column
    "n1000": (1000, [1, -1, 30, -30], 13),
}
VECS = ("r", "p", "s", "w", "z", "rh", "x", "q", "y")


def _t(df):
    return tp.df_to_f64(df)


def _j(df):
    return jp.df_to_f64(df)


def _carry(jdf):
    """A JAX DF pair carried across to the port (CPU)."""
    return convert.df_from_arrays(np.asarray(jdf.hi), np.asarray(jdf.lo),
                                  device="cpu")


@functools.cache
def _setup(case):
    """A JAX DF operator, the port's copy of it, and random DF inputs
    (JAX pairs and their copies) from a seeded NumPy generator."""
    n, offsets, seed = CASES[case]
    A = jprob.build_problem(jgen.banded_random(n, offsets, seed=seed),
                            dtype="df32", multiple=1).A
    At = convert.operator_from_arrays(
        "dia", {"vals_hi": np.asarray(A.vals.hi),
                "vals_lo": np.asarray(A.vals.lo)},
        {"offsets": A.offsets, "n": n}, device="cpu")
    rng = np.random.default_rng(5)
    jv = {k: jp.df_from_f64(rng.standard_normal(n)) for k in VECS}
    jv.update({k: jp.df_from_f64(np.float64(v)) for k, v in
               (("be", 0.3), ("om", 0.2), ("al", 0.7), ("rtr", 2.5))})
    return A, At, jv, {k: _carry(v) for k, v in jv.items()}


def _vec(got, want, tol):
    np.testing.assert_allclose(_t(got), _j(want), rtol=tol, atol=tol)


def _dot(got, want, u, v):
    scale = np.abs(_j(u) * _j(v)).sum()
    assert abs(float(_t(got)) - float(_j(want))) <= 1e-12 * scale


@pytest.mark.parametrize("case", list(CASES))
def test_ca_k1_df_twin_matches_jax(case):
    A, At, jv, tv = _setup(case)
    p2x = jp.vfma(jv["r"], jv["be"], jp.vfma(jv["p"], -jv["om"], jv["s"]))
    s2x = jp.vfma(jv["w"], jv["be"], jp.vfma(jv["s"], -jv["om"], jv["z"]))
    z2x = jdia.dia_spmv_df(A, s2x)
    qx = jp.vfma(jv["r"], -jv["al"], s2x)
    yx = jp.vfma(jv["w"], -jv["al"], z2x)
    p2, s2, z2, q, y, qTy, yTy, omega = tfca.fused_ca_k1_df(
        At.vals, tv["r"], tv["p"], tv["s"], tv["w"], tv["z"],
        (tv["al"], tv["be"], tv["om"]), At.offsets)
    _vec(p2, p2x, 1e-12)
    _vec(s2, s2x, 1e-12)
    _vec(q, qx, 1e-12)
    _vec(z2, z2x, 1e-11)
    _vec(y, yx, 1e-11)
    _dot(qTy, jp.df_dot(qx, yx), qx, yx)
    _dot(yTy, jp.df_dot(yx, yx), yx, yx)
    np.testing.assert_allclose(float(omega), float(qTy) / float(yTy),
                               rtol=1e-13)


@pytest.mark.parametrize("case", list(CASES))
def test_ca_k2_df_twin_matches_jax(case):
    A, At, jv, tv = _setup(case)
    r2x = jp.vfma(jv["q"], -jv["om"], jv["y"])
    w2x = jdia.dia_spmv_df(A, r2x)
    x2x = jp.vfma(jp.vfma(jv["x"], jv["al"], jv["p"]), jv["om"], jv["q"])
    out = tfca.fused_ca_k2_df(
        At.vals, tv["q"], tv["y"], tv["x"], tv["p"], tv["rh"], tv["s"],
        tv["z"], (tv["al"], tv["om"], tv["rtr"]), At.offsets)
    x2, r2, w2, dot_r, rTr, rhTw, rhTs, rhTz, beta, alpha = out
    _vec(x2, x2x, 1e-12)
    _vec(r2, r2x, 1e-12)
    _vec(w2, w2x, 1e-11)
    rh = jv["rh"]
    for got, (u, v) in zip((dot_r, rTr, rhTw, rhTs, rhTz),
                           ((r2x, r2x), (rh, r2x), (rh, w2x),
                            (rh, jv["s"]), (rh, jv["z"]))):
        _dot(got, jp.df_dot(u, v), u, v)
    b = (0.7 / 0.2) * (float(rTr) / 2.5)
    np.testing.assert_allclose(float(beta), b, rtol=1e-13)
    np.testing.assert_allclose(
        float(alpha),
        float(rTr) / (float(rhTw) + b * (float(rhTs) - 0.2 * float(rhTz))),
        rtol=1e-13)


def test_wrappers_count_nothing_on_the_cpu():
    _, At, _, tv = _setup("n1000")
    fns = (tfca.fused_ca_k1_df, tfca.fused_ca_k2_df, tspmv.dia_spmv_df)
    before = [f.launches for f in fns]
    tfca.fused_ca_k1_df(At.vals, tv["r"], tv["p"], tv["s"], tv["w"],
                        tv["z"], (tv["al"], tv["be"], tv["om"]), At.offsets)
    assert [f.launches for f in fns] == before


# --- solves -----------------------------------------------------------------

SOLVES = [(2048, [1, -1, 16, -16], 5), (4096, [1, -1, 16, -16], 6)]
TOL = 1e-11


@functools.cache
def _jax_solve(n, offsets, seed):
    pj = jprob.build_problem(jgen.banded_random(n, list(offsets), seed=seed),
                             dtype="df32", multiple=1)
    res = japi.solve(pj.A, pj.b, method="ca_bicgstab",
                     cfg=jcfg.SolverConfig(tol=TOL, max_iter=400,
                                           dtype="df32"))
    return int(res.n_iter), bool(res.converged), _j(res.x)


def _port_problem(n, offsets, seed):
    return tprob.build_problem(tgen.banded_random(n, list(offsets),
                                                  seed=seed),
                               dtype="df32", multiple=1, device="cpu")


@pytest.mark.parametrize("n,offsets,seed", SOLVES)
def test_df32_ca_solve_matches_jax(n, offsets, seed, monkeypatch):
    """api.solve takes the fused DF driver (its twins on the CPU): K1 and
    K2 once per iteration."""
    calls = {"k1": 0, "k2": 0}
    for key, name in (("k1", "fused_ca_k1_df"), ("k2", "fused_ca_k2_df")):
        def spy(*args, _fn=getattr(tfca, name), _key=key):
            calls[_key] += 1
            return _fn(*args)
        monkeypatch.setattr(tfca, name, spy)
    pt = _port_problem(n, offsets, seed)
    res = tapi.solve(pt.A, pt.b, method="ca_bicgstab",
                     cfg=SolverConfig(tol=TOL, max_iter=400, dtype="df32"))
    k, conv, xj = _jax_solve(n, tuple(offsets), seed)
    assert conv and bool(res.converged)
    assert abs(res.n_iter - k) <= 2, (res.n_iter, k)
    assert calls == {"k1": res.n_iter, "k2": res.n_iter}
    assert tp.is_df(res.x) and res.x.shape == (n,)
    assert np.abs(xj - 1.0).max() < 1e-8
    assert np.abs(_t(res.x) - 1.0).max() < 1e-8
    hist = res.history.numpy()
    assert res.history.dtype == torch.float32
    assert np.isfinite(hist[:res.n_iter]).all()
    assert np.isnan(hist[res.n_iter:]).all()


def test_fused_ca_df_route_equals_the_unfused_solver_on_the_cpu():
    """On the CPU the fused route's twins take the unfused CA solver's DF
    operation sequence: same iterations, same iterate to rounding."""
    n, offsets, seed = SOLVES[0]
    pt = _port_problem(n, offsets, seed)
    cfg = SolverConfig(tol=TOL, max_iter=400, dtype="df32")
    fused = tfca.ca_bicgstab_fused_df(pt.A, pt.b, pt.x0, cfg)
    plain = CLASSIC_SOLVERS["ca_bicgstab"](
        lambda v: tlayout.spmv(pt.A, v), Comm(), pt.b, pt.x0, cfg)
    assert fused.n_iter == plain.n_iter
    np.testing.assert_allclose(_t(fused.x), _t(plain.x), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(fused.history.numpy(),
                               plain.history.numpy(), rtol=1e-6)
    assert bool(fused.converged) and bool(plain.converged)
