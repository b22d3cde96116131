"""Port vs JAX package: the fused iteration bodies of df32 pipelined
BiCGStab (ops/cuda_pipe_df_bodies.py, the port's kernels 16 and 17) and
the solver that runs them, solvers/bicgstab.pipe_bicgstab on DF pairs off
the fully fused DIA route: on ELL and hybrid layouts, with out_iter and
on a Chebyshev operator (test_torch_cheby.py).

The twins (what the wrappers run for CPU tensors) are held to the JAX
package's XLA expressions for the same quantities (vfma, df_dot), as
tests/test_torch_fused_pipe_df.py holds the phases: vectors rtol = atol =
1e-12, dots within 1e-12 sum |u_i v_i|. Solves at tol 1e-11 against the
JAX api.solve, whose CPU route is its unfused XLA pipelined solver (its
fused bodies engage on its TPU): n_iter within +-2, both converged,
max|x-1| < 1e-8.
"""
import contextlib
import functools
import io

import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.api as japi
import mpi_bicgstab_tpu.models.generators as jgen
import mpi_bicgstab_tpu.models.problem as jprob
import mpi_bicgstab_tpu.ops.precision as jp
import mpi_bicgstab_tpu.ops.sparse as jsparse
import mpi_bicgstab_tpu.utils.config as jcfg
import mpi_bicgstab_tpu_torch.api as tapi
import mpi_bicgstab_tpu_torch.models.generators as tgen
import mpi_bicgstab_tpu_torch.models.problem as tprob
import mpi_bicgstab_tpu_torch.ops.cuda_pipe_df_bodies as cpb
import mpi_bicgstab_tpu_torch.ops.layout as tlayout
import mpi_bicgstab_tpu_torch.ops.precision as tp
import mpi_bicgstab_tpu_torch.ops.sparse as tsparse
import mpi_bicgstab_tpu_torch.solvers.bicgstab as tb
from mpi_bicgstab_tpu_torch import convert
from mpi_bicgstab_tpu_torch.parallel.comm import Comm
from mpi_bicgstab_tpu_torch.utils.config import SolverConfig

torch.set_num_threads(1)
VECS = ("r", "p", "s", "w", "z", "t", "v", "x", "q", "y", "rh")


@functools.cache
def _inputs(n, seed):
    """Random DF vectors and scalars as JAX pairs and the port's copies,
    from a seeded NumPy generator."""
    rng = np.random.default_rng(seed)
    jv = {k: jp.df_from_f64(rng.standard_normal(n)) for k in VECS}
    jv.update({k: jp.df_from_f64(np.float64(c) * (1 + 1e-9)) for k, c in
               (("al", 0.7), ("be", 0.3), ("om", 0.25))})
    tv = {k: convert.df_from_arrays(np.asarray(v.hi), np.asarray(v.lo),
                                    device="cpu") for k, v in jv.items()}
    return jv, tv


def _vec(got, want):
    np.testing.assert_allclose(tp.df_to_f64(got), jp.df_to_f64(want),
                               rtol=1e-12, atol=1e-12)


def _dot(got, u, v):
    scale = np.abs(jp.df_to_f64(u) * jp.df_to_f64(v)).sum()
    assert abs(float(got) - float(jp.df_to_f64(jp.df_dot(u, v)))) \
        <= 1e-12 * scale


@pytest.mark.parametrize("n,seed", [(4096, 11), (1000, 13)])
def test_body_a_twin_matches_jax(n, seed):
    jv, tv = _inputs(n, seed)
    al, be, om = jv["al"], jv["be"], jv["om"]
    p2 = jp.vfma(jv["r"], be, jp.vfma(jv["p"], -om, jv["s"]))
    s2 = jp.vfma(jv["w"], be, jp.vfma(jv["s"], -om, jv["z"]))
    z2 = jp.vfma(jv["t"], be, jp.vfma(jv["z"], -om, jv["v"]))
    q = jp.vfma(jv["r"], -al, s2)
    y = jp.vfma(jv["w"], -al, z2)
    out = cpb.fused_body_a(*(tv[k] for k in ("r", "p", "s", "w", "z", "t",
                                             "v")),
                           (tv["al"], tv["be"], tv["om"]))
    for got, want in zip(out[:5], (p2, s2, z2, q, y)):
        _vec(got, want)
    qTy, yTy = out[5]
    _dot(qTy, q, y)
    _dot(yTy, y, y)


@pytest.mark.parametrize("n,seed", [(4096, 11), (1000, 13)])
def test_body_b_twin_matches_jax(n, seed):
    jv, tv = _inputs(n, seed)
    al, om = jv["al"], jv["om"]
    x2 = jp.vfma(jp.vfma(jv["x"], al, jv["p"]), om, jv["q"])
    r2 = jp.vfma(jv["q"], -om, jv["y"])
    w2 = jp.vfma(jv["y"], -om, jp.vfma(jv["t"], -al, jv["v"]))
    out = cpb.fused_body_b(*(tv[k] for k in ("x", "p", "q", "y", "t", "v",
                                             "rh", "s", "z")),
                           (tv["al"], tv["om"]))
    for got, want in zip(out[:3], (x2, r2, w2)):
        _vec(got, want)
    rh = jv["rh"]
    for got, (u, v) in zip(out[3], ((r2, r2), (rh, r2), (rh, w2),
                                    (rh, jv["s"]), (rh, jv["z"]))):
        _dot(got, u, v)


def test_wrappers_count_nothing_on_the_cpu():
    _, tv = _inputs(1000, 13)
    before = (cpb.fused_body_a.launches, cpb.fused_body_b.launches)
    cpb.fused_body_a(*(tv[k] for k in ("r", "p", "s", "w", "z", "t", "v")),
                     (tv["al"], tv["be"], tv["om"]))
    assert (cpb.fused_body_a.launches, cpb.fused_body_b.launches) == before


# --- solves ------------------------------------------------------------------

TOL = 1e-11


def _with_stragglers(mod, csr, k, seed):
    """csr plus k random off-band entries: the hybrid layout's ELL rest."""
    rng = np.random.default_rng(seed)
    n = csr.nrows
    rows = np.repeat(np.arange(n), csr.row_lengths)
    coo = mod.COOMatrix(np.concatenate([rows, rng.integers(0, n, k)]),
                        np.concatenate([csr.col, rng.integers(0, n, k)]),
                        np.concatenate([csr.val, rng.uniform(-0.1, 0.1, k)]),
                        csr.shape)
    return mod.coo_to_csr(coo, sum_duplicates=True)


def _pair(fmt):
    args = (3000, [1, -1, 50, -50])
    if fmt == "hybrid":
        return (_with_stragglers(tsparse, tgen.banded_random(*args, seed=4),
                                 400, 5),
                _with_stragglers(jsparse, jgen.banded_random(*args, seed=4),
                                 400, 5))
    return tgen.banded_random(*args, seed=4), jgen.banded_random(*args,
                                                                 seed=4)


def _spy(monkeypatch):
    calls = {"fused_body_a": 0, "fused_body_b": 0}
    for name in calls:
        def spy(*args, _fn=getattr(cpb, name), _key=name):
            calls[_key] += 1
            return _fn(*args)
        monkeypatch.setattr(cpb, name, spy)
    return calls


@pytest.mark.parametrize("fmt,out_iter", [("ell", 0), ("hybrid", 0),
                                          ("dia", 3)])
def test_df32_pipe_solves_where_it_raised(fmt, out_iter, monkeypatch):
    """df32 pipe_bicgstab on ELL, on a hybrid layout and (on DIA) with
    out_iter takes the fused bodies, once each per iteration, and matches
    the JAX package's solve."""
    csr_t, csr_j = _pair(fmt)
    pt = tprob.build_problem(csr_t, dtype="df32", multiple=1, device="cpu",
                             format=fmt)
    pj = jprob.build_problem(csr_j, dtype="df32", multiple=1, format=fmt)
    assert type(pt.A).__name__ == type(pj.A).__name__
    calls = _spy(monkeypatch)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rt = tapi.solve(pt.A, pt.b, method="pipe_bicgstab", cfg=SolverConfig(
            tol=TOL, max_iter=300, dtype="df32", out_iter=out_iter))
    with contextlib.redirect_stdout(io.StringIO()):
        rj = japi.solve(pj.A, pj.b, method="pipe_bicgstab",
                        cfg=jcfg.SolverConfig(tol=TOL, max_iter=300,
                                              dtype="df32", out_iter=out_iter))
        int(rj.n_iter)
    assert bool(rt.converged) and bool(rj.converged)
    assert abs(rt.n_iter - int(rj.n_iter)) <= 2
    assert calls == {"fused_body_a": rt.n_iter, "fused_body_b": rt.n_iter}
    assert np.abs(tp.df_to_f64(rt.x) - 1.0).max() < 1e-8
    if out_iter:
        port_lines = [ln for ln in out.getvalue().splitlines()
                      if ln.startswith("iter ")]
        assert len(port_lines) == rt.n_iter // out_iter


def test_bodies_route_equals_the_fused_dia_route():
    """On a DF DiaMatrix the fully fused phases (kernels 14-15) and the
    fused bodies with the DF SpMV compute the same recurrence: the same
    iterations and iterates to the last bits of the dots' order."""
    pt = tprob.build_problem(tgen.banded_random(2048, [1, -1, 16, -16],
                                                seed=5),
                             dtype="df32", multiple=1, device="cpu")
    cfg = SolverConfig(tol=0.0, max_iter=9, dtype="df32")
    fused = tapi.FUSED_DF["pipe_bicgstab"](pt.A, pt.b, pt.x0, cfg)
    bodies = tb.pipe_bicgstab(lambda v: tlayout.spmv(pt.A, v), Comm(), pt.b,
                              pt.x0, cfg)
    assert fused.n_iter == bodies.n_iter == 9
    np.testing.assert_allclose(fused.history.numpy(), bodies.history.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(tp.df_to_f64(fused.x), tp.df_to_f64(bodies.x),
                               rtol=0, atol=1e-12)
