"""Port vs JAX package: the df32 (double-float) pipelined path — the
plain twins of the fully fused DF phases A and B, and df32
pipe_bicgstab / pipe_bicgstab_rr solves through api.solve.

The twins (what the port's wrappers run for CPU tensors) are held to the
JAX package's XLA expressions for the same quantities (vfma,
dia_spmv_df, df_dot on a JAX DF operator carried across), exactly as
tests/test_fused_pipe.py holds the JAX DF phases; the JAX DF Pallas
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
import mpi_bicgstab_tpu_torch.ops.cuda_fused_pipe_df as tfpd
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
VECS = ("w", "r", "p", "s", "z", "v", "x", "q", "y", "t", "rh")


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
    rng = np.random.default_rng(6)
    jv = {k: jp.df_from_f64(rng.standard_normal(n)) for k in VECS}
    jv.update({k: jp.df_from_f64(np.float64(v)) for k, v in
               (("be", 0.3), ("om", 0.25), ("al", 0.7), ("rtr", 2.5))})
    return A, At, jv, {k: _carry(v) for k, v in jv.items()}


def _vec(got, want, tol):
    np.testing.assert_allclose(_t(got), _j(want), rtol=tol, atol=tol)


def _dot(got, want, u, v):
    scale = np.abs(_j(u) * _j(v)).sum()
    assert abs(float(_t(got)) - float(_j(want))) <= 1e-12 * scale


@pytest.mark.parametrize("case", list(CASES))
def test_phase_a_df_twin_matches_jax(case):
    A, At, jv, tv = _setup(case)
    al, be, om = jv["al"], jv["be"], jv["om"]
    tx = jdia.dia_spmv_df(A, jv["w"])
    z2x = jp.vfma(tx, be, jp.vfma(jv["z"], -om, jv["v"]))
    p2x = jp.vfma(jv["r"], be, jp.vfma(jv["p"], -om, jv["s"]))
    s2x = jp.vfma(jv["w"], be, jp.vfma(jv["s"], -om, jv["z"]))
    qx = jp.vfma(jv["r"], -al, s2x)
    yx = jp.vfma(jv["w"], -al, z2x)
    t, p2, s2, z2, q, y, qTy, yTy, omega = tfpd.fused_phase_a_df(
        At.vals, *(tv[k] for k in ("w", "r", "p", "s", "z", "v")),
        (tv["al"], tv["be"], tv["om"]), At.offsets)
    for got, want, tol in ((t, tx, 1e-11), (z2, z2x, 1e-11),
                           (y, yx, 1e-11), (p2, p2x, 1e-12),
                           (s2, s2x, 1e-12), (q, qx, 1e-12)):
        _vec(got, want, tol)
    _dot(qTy, jp.df_dot(qx, yx), qx, yx)
    _dot(yTy, jp.df_dot(yx, yx), yx, yx)
    np.testing.assert_allclose(float(omega), float(qTy) / float(yTy),
                               rtol=1e-13)


@pytest.mark.parametrize("case", list(CASES))
def test_phase_b_df_twin_matches_jax(case):
    A, At, jv, tv = _setup(case)
    al, om = jv["al"], jv["om"]
    v2x = jdia.dia_spmv_df(A, jv["z"])
    w2x = jp.vfma(jv["y"], -om, jp.vfma(jv["t"], -al, v2x))
    x2x = jp.vfma(jp.vfma(jv["x"], al, jv["p"]), om, jv["q"])
    r2x = jp.vfma(jv["q"], -om, jv["y"])
    out = tfpd.fused_phase_b_df(
        At.vals, *(tv[k] for k in ("z", "x", "p", "q", "y", "t", "rh",
                                   "s")),
        (tv["al"], tv["om"], tv["rtr"]), At.offsets)
    v2, x2, r2, w2, dot_r, rTr, rhTw, rhTs, rhTz, beta, alpha = out
    for got, want, tol in ((v2, v2x, 1e-11), (w2, w2x, 1e-11),
                           (x2, x2x, 1e-12), (r2, r2x, 1e-12)):
        _vec(got, want, tol)
    rh = jv["rh"]
    for got, (u, v) in zip((dot_r, rTr, rhTw, rhTs, rhTz),
                           ((r2x, r2x), (rh, r2x), (rh, w2x),
                            (rh, jv["s"]), (rh, jv["z"]))):
        _dot(got, jp.df_dot(u, v), u, v)
    b = (0.7 / 0.25) * (float(rTr) / 2.5)
    np.testing.assert_allclose(float(beta), b, rtol=1e-13)
    np.testing.assert_allclose(
        float(alpha),
        float(rTr) / (float(rhTw) + b * (float(rhTs) - 0.25 * float(rhTz))),
        rtol=1e-13)


def test_wrappers_count_nothing_on_the_cpu():
    _, At, _, tv = _setup("n1000")
    fns = (tfpd.fused_phase_a_df, tfpd.fused_phase_b_df, tspmv.dia_spmv_df)
    before = [f.launches for f in fns]
    tfpd.fused_phase_b_df(
        At.vals, *(tv[k] for k in ("z", "x", "p", "q", "y", "t", "rh",
                                   "s")),
        (tv["al"], tv["om"], tv["rtr"]), At.offsets)
    assert [f.launches for f in fns] == before


# --- solves -----------------------------------------------------------------

SOLVES = [(2048, [1, -1, 16, -16], 5), (4096, [1, -1, 16, -16], 6)]
TOL = 1e-11


@functools.cache
def _jax_solve(n, offsets, seed, method):
    pj = jprob.build_problem(jgen.banded_random(n, list(offsets), seed=seed),
                             dtype="df32", multiple=1)
    res = japi.solve(pj.A, pj.b, method=method, cfg=jcfg.SolverConfig(
        tol=TOL, max_iter=400, krr=3, nrr=2, dtype="df32"))
    return int(res.n_iter), bool(res.converged), _j(res.x)


def _port_problem(n, offsets, seed):
    return tprob.build_problem(tgen.banded_random(n, list(offsets),
                                                  seed=seed),
                               dtype="df32", multiple=1, device="cpu")


def _spy(monkeypatch, calls):
    """Count the fused driver's calls of its phases and of the DF SpMV
    (the twins on the CPU)."""
    for name in ("fused_phase_a_df", "fused_phase_b_df", "dia_spmv_df"):
        def spy(*args, _fn=getattr(tfpd, name), _key=name):
            calls[_key] += 1
            return _fn(*args)
        monkeypatch.setattr(tfpd, name, spy)


@pytest.mark.parametrize("method,n,offsets,seed",
                         [("pipe_bicgstab", *SOLVES[0]),
                          ("pipe_bicgstab", *SOLVES[1]),
                          ("pipe_bicgstab_rr", *SOLVES[0]),
                          ("pipe_bicgstab_rr", *SOLVES[1])])
def test_df32_pipe_solve_matches_jax(method, n, offsets, seed, monkeypatch):
    """api.solve takes the fused DF driver: phase A and B once per
    recurrence iteration; r0, w0 and the true residual are its only DF
    SpMVs besides the replacement iterations' five each (krr 3, nrr 2:
    iterations 3 and 6)."""
    calls = dict.fromkeys(("fused_phase_a_df", "fused_phase_b_df",
                           "dia_spmv_df"), 0)
    _spy(monkeypatch, calls)
    pt = _port_problem(n, offsets, seed)
    res = tapi.solve(pt.A, pt.b, method=method, cfg=SolverConfig(
        tol=TOL, max_iter=400, krr=3, nrr=2, dtype="df32"))
    k, conv, xj = _jax_solve(n, tuple(offsets), seed, method)
    assert conv and bool(res.converged)
    assert abs(res.n_iter - k) <= 2, (res.n_iter, k)
    n_rr = 2 if method == "pipe_bicgstab_rr" else 0
    assert res.n_iter > 3 * n_rr          # every replacement fired
    assert calls == {"fused_phase_a_df": res.n_iter - n_rr,
                     "fused_phase_b_df": res.n_iter - n_rr,
                     "dia_spmv_df": 3 + 5 * n_rr}
    assert tp.is_df(res.x) and res.x.shape == (n,)
    assert np.abs(xj - 1.0).max() < 1e-8
    assert np.abs(_t(res.x) - 1.0).max() < 1e-8
    hist = res.history.numpy()
    assert res.history.dtype == torch.float32
    assert np.isfinite(hist[:res.n_iter]).all()
    assert np.isnan(hist[res.n_iter:]).all()


@pytest.mark.parametrize("method", ["pipe_bicgstab", "pipe_bicgstab_rr"])
def test_fused_pipe_df_route_equals_the_unfused_solver(method):
    """The fused DF driver, replacement iterations included, against the
    unfused solver on the CPU: phase A's z' and phase B's w' are the
    unfused solver's axpys on the same t and v, so the two agree to the
    last bits of the dots' order."""
    n, offsets, seed = SOLVES[0]
    pt = _port_problem(n, offsets, seed)
    cfg = SolverConfig(tol=0.0, max_iter=9, krr=2, nrr=3, dtype="df32")
    fused = tapi.FUSED_DF[method](pt.A, pt.b, pt.x0, cfg)
    plain = CLASSIC_SOLVERS[method](lambda v: tlayout.spmv(pt.A, v),
                                    Comm(), pt.b, pt.x0, cfg)
    assert fused.n_iter == plain.n_iter == 9
    np.testing.assert_allclose(fused.history.numpy(),
                               plain.history.numpy(), rtol=1e-6)
    np.testing.assert_allclose(_t(fused.x), _t(plain.x), rtol=0,
                               atol=1e-12)
