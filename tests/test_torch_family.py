"""Port vs JAX package: the rest of the classic family on its unfused
route (float64 and non-DIA operators), BiCGStab(l), the generators they
need, the tol=0 contract, the dispatch between fused and unfused routes,
and the CLI's new flags.

float64 solves: n_iter within +-2 of JAX's api.solve (+-2l for
BiCGStab(l), whose n_iter moves in steps of l), the residual history
within rtol 1e-6 over the common prefix (NaN where both have no entry),
the same `converged`, max|x-1| < 1e-6. Generators: equal arrays.
"""
import contextlib
import dataclasses
import io
import runpy
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.api as japi
import mpi_bicgstab_tpu.models.generators as jgen
import mpi_bicgstab_tpu.models.problem as jprob
import mpi_bicgstab_tpu.utils.config as jcfg
import mpi_bicgstab_tpu_torch.api as tapi
import mpi_bicgstab_tpu_torch.models.generators as tgen
import mpi_bicgstab_tpu_torch.models.problem as tprob
from mpi_bicgstab_tpu_torch import convert
from mpi_bicgstab_tpu_torch.utils.config import SolverConfig

torch.set_num_threads(1)

NEW = ("ca_bicgstab", "pipe_bicgstab", "pipe_bicgstab_rr", "bicgstab_l2",
       "bicgstab_l4")
F64_CASES = [
    ("banded_dia", lambda g: g.banded_random(6000, [1, -1, 18, -18, 330,
                                                    -330], seed=2), "dia"),
    ("banded_ell", lambda g: g.banded_random(3000, [1, -1, 50, -50],
                                             seed=5), "ell"),
]


def _step(method):
    return int(method[-1]) if method.startswith("bicgstab_l") else 1


@pytest.mark.parametrize("method", NEW)
@pytest.mark.parametrize("name,gen,fmt", F64_CASES,
                         ids=[c[0] for c in F64_CASES])
def test_f64_solve_matches_jax(name, gen, fmt, method):
    kw = dict(tol=1e-10, max_iter=300, krr=4, nrr=2)
    pj = jprob.build_problem(gen(jgen), dtype=jnp.float64, format=fmt)
    rj = japi.solve(pj.A, pj.b, method=method,
                    cfg=jcfg.SolverConfig(dtype=jnp.float64, **kw))
    pt = tprob.build_problem(gen(tgen), dtype="float64", format=fmt,
                             device="cpu")
    rt = tapi.solve(pt.A, pt.b, method=method, cfg=SolverConfig(**kw))
    assert abs(rt.n_iter - int(rj.n_iter)) <= 2 * _step(method)
    k = min(rt.n_iter, int(rj.n_iter), kw["max_iter"])
    np.testing.assert_allclose(rt.history[:k].numpy(),
                               np.asarray(rj.history)[:k], rtol=1e-6)
    assert bool(rt.converged) == bool(rj.converged)
    assert bool(rt.converged)
    assert float((rt.x - 1.0).abs().max()) < 1e-6


def test_skew_fixture_needs_bicgstab_l():
    """skew_banded's conjugate-pair spectrum: classic BiCGStab ends
    unconverged in both packages, BiCGStab(2) converges in both."""
    kw = dict(tol=1e-10, max_iter=2000, restarts=0)
    pj = jprob.build_problem(jgen.skew_banded(1024, seed=0),
                             dtype=jnp.float64)
    pt = tprob.build_problem(tgen.skew_banded(1024, seed=0),
                             dtype="float64", device="cpu")
    cfg_j = jcfg.SolverConfig(dtype=jnp.float64, **kw)
    cfg_t = SolverConfig(**kw)
    assert not bool(japi.solve(pj.A, pj.b, method="bicgstab",
                               cfg=cfg_j).converged)
    assert not bool(tapi.solve(pt.A, pt.b, method="bicgstab",
                               cfg=cfg_t).converged)
    lj = japi.solve(pj.A, pj.b, method="bicgstab_l2", cfg=cfg_j)
    lt = tapi.solve(pt.A, pt.b, method="bicgstab_l2", cfg=cfg_t)
    assert bool(lj.converged) and bool(lt.converged)
    assert float(lt.true_relres) < 1e-9
    assert float((lt.x - 1.0).abs().max()) < 1e-7
    # slow, erratic convergence: a last-bit difference moves the count
    # by tens of iterations in either package (1074 in JAX's, 1144 in
    # the port's); both stay clear of max_iter, as the JAX test asks
    assert lt.n_iter < 1600 and int(lj.n_iter) < 1600


@pytest.mark.parametrize("method", tapi.METHODS)
def test_tol0_runs_exactly_max_iter(method):
    """tol == 0 runs exactly max_iter iterations (in steps of l for
    BiCGStab(l): the first multiple of l at or past max_iter), on the
    fused float32 route and the unfused float64 route alike."""
    l = _step(method)
    for dtype in ("float32", "float64"):
        pt = tprob.build_problem(tgen.poisson2d(12), dtype=dtype,
                                 device="cpu")
        for max_iter in (1, 7, 30):
            res = tapi.solve(pt.A, pt.b, method=method, cfg=SolverConfig(
                tol=0.0, max_iter=max_iter, krr=3, nrr=2, dtype=dtype))
            assert res.n_iter == -(-max_iter // l) * l
            assert res.history.shape == (max_iter,)


def test_bicgstab_l_history_slots():
    """One history entry per outer iteration at slot k + l - 1; the last
    one is dropped when its slot is past max_iter (the JAX package's
    mode="drop")."""
    pt = tprob.build_problem(tgen.poisson2d(12), device="cpu")
    res = tapi.solve(pt.A, pt.b, method="bicgstab_l4",
                     cfg=SolverConfig(tol=0.0, max_iter=6))
    assert res.n_iter == 8
    h = res.history.numpy()
    assert np.isfinite(h[3]) and np.isnan(np.delete(h, 3)).all()


GENERATORS = [
    ("skew_banded", (1024,), {"seed": 0}),
    ("skew_banded", (300,), {"w": 7, "diag": 0.1, "seed": 3}),
    ("skew_banded", (1,), {}),                       # band wider than n
    ("banded_tough", (2000, [1, -1, 30, -30, 0]), {"seed": 2}),
    ("banded_tough", (500, [2, -3]), {"dominance": 0.5}),
]


@pytest.mark.parametrize("name,args,kw", GENERATORS,
                         ids=[g[0] + str(i) for i, g in enumerate(GENERATORS)])
def test_generators_equal_jax(name, args, kw):
    a = getattr(tgen, name)(*args, **kw)
    b = getattr(jgen, name)(*args, **kw)
    assert tuple(a.shape) == tuple(b.shape)
    for field in ("ptr", "col", "val"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


@pytest.mark.parametrize("dtype,fmt,out_iter,fused", [
    ("float32", "dia", 0, True),
    ("float64", "dia", 0, False),
    ("float32", "ell", 0, False),
    ("float32", "dia", 2, False),
])
def test_dispatch(dtype, fmt, out_iter, fused, monkeypatch, capsys):
    """float32 on a DiaMatrix goes to the method's fused driver, as the
    JAX _solve_jit routes it; float64, other layouts, out_iter != 0 and
    BiCGStab(l) go to the unfused solver."""
    took = []
    for table, route in ((tapi.FUSED, "fused"),
                         (tapi.CLASSIC_SOLVERS, "unfused")):
        for name, fn in list(table.items()):
            def spy(*args, _fn=fn, _route=route):
                took.append(_route)
                return _fn(*args)
            monkeypatch.setitem(table, name, spy)
    pt = tprob.build_problem(tgen.banded_random(2000, [1, -1, 9, -9],
                                                seed=1),
                             dtype=dtype, format=fmt, device="cpu")
    for method in tapi.METHODS:
        took.clear()
        res = tapi.solve(pt.A, pt.b, method=method, cfg=SolverConfig(
            tol=1e-5, max_iter=50, dtype=dtype, out_iter=out_iter))
        assert bool(res.converged)
        want = "fused" if fused and method in tapi.FUSED else "unfused"
        assert took and set(took) == {want}, (method, took)
    capsys.readouterr()


def test_config_carries_krr_nrr():
    cfg = convert.config_from_fields(dataclasses.asdict(
        jcfg.SolverConfig(tol=1e-7, krr=7, nrr=3, dtype=jnp.float32)))
    assert (cfg.krr, cfg.nrr, cfg.dtype) == (7, 3, torch.float32)
    assert (SolverConfig().krr, SolverConfig().nrr) == (
        jcfg.SolverConfig().krr, jcfg.SolverConfig().nrr)


def _run_module(argv, monkeypatch):
    """`python -m mpi_bicgstab_tpu_torch <argv>` in this process."""
    monkeypatch.setattr(sys, "argv", ["mpi_bicgstab_tpu_torch", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as ex:
        runpy.run_module("mpi_bicgstab_tpu_torch", run_name="__main__",
                         alter_sys=True)
    fields = dict(line.split(":", 1) for line in out.getvalue().splitlines())
    return ex.value.code, {k.strip(): v.strip() for k, v in fields.items()}


@pytest.mark.parametrize("method,extra", [
    ("ca_bicgstab", []),
    ("pipe_bicgstab", []),
    ("pipe_bicgstab_rr", ["--krr", "3", "--nrr", "2"]),
    ("bicgstab_l2", []),
    ("bicgstab_l4", []),
])
def test_cli_new_methods_on_cpu(method, extra, monkeypatch):
    code, f = _run_module(["solve", "--matrix", "transport-like:8192",
                           "--method", method, "--dtype", "float32",
                           "--tol", "1e-5", "--device", "cpu", *extra],
                          monkeypatch)
    assert code == 0 and f["converged"] == "True", f
    assert f["method"] == method and f["n"] == "8192"


def test_cli_skew_spec(monkeypatch):
    args = ["solve", "--matrix", "skew:1024", "--tol", "1e-10",
            "--max-iter", "2000", "--device", "cpu"]
    code, f = _run_module([*args, "--method", "bicgstab_l2"], monkeypatch)
    assert code == 0 and f["converged"] == "True"
    code, f = _run_module([*args, "--method", "bicgstab", "--restarts",
                           "0"], monkeypatch)
    assert code == 2 and f["converged"] == "False"
    # the uniform generator solves too: padded to one 1024-row tile, its
    # columns all lie in the tile's window, so 'auto' takes windowed-ELL
    # (as the JAX CLI does; larger uniform matrices take the butterfly)
    code, f = _run_module(["solve", "--matrix", "uniform:512", "--tol",
                           "1e-10", "--device", "cpu"], monkeypatch)
    assert code == 0 and f["converged"] == "True"
    assert f["layout"] == "WindowEllMatrix" and f["n"] == "512"


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("phase", ["ca", "pipe", "pipe_rr", "pipe_rr_f64",
                                   "l2"])
def test_chip_smoke_paths_on_cpu(phase):
    """chip_smoke's paths of this slice at n = 8192 on the CPU: converged,
    max|x-1| within bounds, and no kernel counted (plain twins only)."""
    smoke = _chip_smoke()
    method, dtype, tol, extra = smoke.PATHS[phase]
    report, counts, err = smoke.run_main_path(8192, dtype, tol, "cpu",
                                              method=method, extra=extra)
    assert report["converged"] and report["method"] == method
    assert set(counts.values()) == {0}
    assert err < (1e-3 if dtype == "float32" else 1e-6)


def _counts(**kw):
    base = dict.fromkeys(("dia_spmv", "fused_k1", "fused_k2", "fused_k3",
                          "fused_ca_k1", "fused_ca_k2", "fused_phase_a",
                          "fused_phase_b"), 0)
    return {**base, **kw}


@pytest.mark.parametrize("method,dtype,it,counts,ok", [
    # f32 fused routes, one segment
    ("bicgstab", "float32", 8, _counts(dia_spmv=2, fused_k1=8, fused_k2=8,
                                       fused_k3=8), True),
    ("ca_bicgstab", "float32", 8, _counts(dia_spmv=3, fused_ca_k1=8,
                                          fused_ca_k2=8), True),
    ("ca_bicgstab", "float32", 8, _counts(dia_spmv=3, fused_ca_k1=8,
                                          fused_ca_k2=7), False),
    ("pipe_bicgstab", "float32", 9, _counts(dia_spmv=8, fused_phase_a=9,
                                            fused_phase_b=9), True),
    # krr 3, nrr 2, 9 iterations: 2 replacements of 6 SpMVs each
    ("pipe_bicgstab_rr", "float32", 9, _counts(
        dia_spmv=16, fused_phase_a=7, fused_phase_b=7), True),
    ("pipe_bicgstab_rr", "float32", 9, _counts(
        dia_spmv=4, fused_phase_a=9, fused_phase_b=9), False),  # no RR
    ("pipe_bicgstab_rr", "float32", 9, _counts(
        dia_spmv=16, fused_phase_a=7, fused_phase_b=9), False),
    # f64 unfused: 2 SpMVs per iteration, 4 more per replacement
    ("pipe_bicgstab_rr", "float64", 14, _counts(dia_spmv=28 + 8 + 4), True),
    ("pipe_bicgstab_rr", "float64", 14, _counts(dia_spmv=28 + 4), False),
    ("bicgstab_l2", "float64", 16, _counts(dia_spmv=32 + 2), True),
    ("bicgstab", "float64", 14, _counts(dia_spmv=28 + 4), True),  # 2 segs
    ("bicgstab", "float64", 14, _counts(dia_spmv=28 + 4,
                                        fused_k1=1), False),
])
def test_chip_smoke_launch_rule(method, dtype, it, counts, ok):
    """The launch counts chip_smoke accepts for a run on the card follow
    from the drivers' code (restarts = 2: up to 3 segments)."""
    smoke = _chip_smoke()
    if ok:
        smoke.check_counts(method, dtype, it, counts, restarts=2)
    else:
        with pytest.raises(smoke.SmokeFailure):
            smoke.check_counts(method, dtype, it, counts, restarts=2)
