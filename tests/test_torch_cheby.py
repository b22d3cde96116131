"""Port vs JAX package: Chebyshev preconditioning (ops/cheby.py, the
chain kernels' plain twins of ops/cuda_cheby.py, and the preconditioned
api.solve / solve_batched / `solve --precond`), on the CPU.

The JAX package's chain kernels run only on its TPU (and in interpret
mode they are in its slow list), so the twins are held to its XLA chain,
ops/cheby.cheby_apply over layout.spmv, on an operator carried across by
convert. Tolerances: float64 rtol 1e-12 (of the largest entry), float32
within 2e-6 of the largest entry (the JAX package's bar for its chain
kernel, tests/test_cheby.py:139), DF within 1e-11 relative. Preconditioned
solves against the JAX api.solve (its unfused XLA route on the CPU):
n_iter within +-2, the history within rtol 1e-6 in float64, max|x-1| <
1e-6 (1e-8 in df32 at tol 1e-11).
"""
import contextlib
import functools
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.api as japi
import mpi_bicgstab_tpu.cli as jcli
import mpi_bicgstab_tpu.models.generators as jgen
import mpi_bicgstab_tpu.models.problem as jprob
import mpi_bicgstab_tpu.ops.cheby as jcheby
import mpi_bicgstab_tpu.ops.precision as jp
import mpi_bicgstab_tpu.utils.config as jcfg
from mpi_bicgstab_tpu.ops.layout import spmv as jspmv
import mpi_bicgstab_tpu_torch.api as tapi
import mpi_bicgstab_tpu_torch.models.generators as tgen
import mpi_bicgstab_tpu_torch.models.problem as tprob
import mpi_bicgstab_tpu_torch.ops.cheby as tcheby
import mpi_bicgstab_tpu_torch.ops.precision as tp
from mpi_bicgstab_tpu_torch import cli, convert
from mpi_bicgstab_tpu_torch.ops import cuda_batched_spmv as cbs
from mpi_bicgstab_tpu_torch.ops import cuda_cheby as cc
from mpi_bicgstab_tpu_torch.ops import cuda_fused_classic as fcl
from mpi_bicgstab_tpu_torch.ops import cuda_fused_classic_df as fcldf
from mpi_bicgstab_tpu_torch.ops.layout import build_operator
from mpi_bicgstab_tpu_torch.utils.config import SolverConfig

torch.set_num_threads(1)


# --- bounds, specs and coefficients ------------------------------------------

@pytest.mark.parametrize("n", [512, 4096])
def test_bounds_parse_and_resolve_match_jax(n):
    csr_t, csr_j = tgen.transport_hard(n), jgen.transport_hard(n)
    assert tcheby.estimate_bounds(csr_t) == jcheby.estimate_bounds(csr_j)
    for spec in ("none", "cheby", "cheby:4", "cheby:3:0.5:100",
                 "cheby:6:0:50"):
        t, j = tcheby.ChebyPrecond.parse(spec), jcheby.ChebyPrecond.parse(spec)
        if j is None:
            assert t is None
            continue
        assert (t.degree, t.lo, t.hi) == (j.degree, j.lo, j.hi)
        rt, rj = t.resolve(csr_t), j.resolve(csr_j)
        assert (rt.degree, rt.lo, rt.hi) == (rj.degree, rj.lo, rj.hi)
    for bad in ("ilu", "jacobi:2"):
        with pytest.raises(ValueError, match="unknown preconditioner"):
            tcheby.ChebyPrecond.parse(bad)
    with pytest.raises(ValueError, match="degree"):
        tcheby.ChebyPrecond(degree=0, lo=1.0, hi=10.0)
    with pytest.raises(ValueError, match="bounds"):
        tcheby.ChebyPrecond(degree=4).resolve()


def test_coefficients_match_jax():
    for degree, lo, hi in ((1, 0.1, 10.0), (8, 0.121, 1210.0),
                           (5, 2e-3, 7.5)):
        t, j = tcheby._coeffs(degree, lo, hi), jcheby._coeffs(degree, lo, hi)
        assert t == j
        for c in (t[0], *(x for pair in t[1] for x in pair)):
            jd = jcheby.df_const(c)
            td = tcheby.df_const(c, "cpu")
            assert (float(td.hi), float(td.lo)) == (float(jd.hi),
                                                    float(jd.lo))
    with pytest.raises(ValueError, match="0 < lo < hi"):
        tcheby._coeffs(4, 5.0, 1.0)


# --- the chains --------------------------------------------------------------

@functools.cache
def _operator(n, dtype):
    """A JAX transport_hard DIA operator and the port's copy of it."""
    csr = jgen.transport_hard(n)
    A = jprob.build_problem(csr, dtype=dtype if dtype == "df32" else
                            getattr(jnp, dtype), multiple=1).A
    arrays = ({"vals_hi": np.asarray(A.vals.hi),
               "vals_lo": np.asarray(A.vals.lo)} if dtype == "df32"
              else {"vals": np.asarray(A.vals)})
    At = convert.operator_from_arrays("dia", arrays,
                                      {"offsets": A.offsets, "n": csr.nrows},
                                      device="cpu")
    return A, At, jcheby.estimate_bounds(csr)


@pytest.mark.parametrize("dtype,n,degree", [("float64", 4096, 8),
                                            ("float32", 4096, 8),
                                            ("df32", 512, 2)])
def test_twin_chains_match_jax_cheby_apply(dtype, n, degree):
    """float64: the port's ChebyOperator.apply (cheby_apply over
    layout.spmv); float32 and df32: the chain kernels' twins, df32 with
    full-precision DF coefficients."""
    A, At, (lo, hi) = _operator(n, dtype)
    v = np.random.default_rng(n).standard_normal(n)
    if dtype == "df32":
        vj = jp.df_from_f64(v)
        ref = jp.df_to_f64(jcheby.cheby_apply(lambda u: jspmv(A, u), vj,
                                              degree, lo, hi))
        got = tp.df_to_f64(cc.cheby_chain_df_plain(
            At.vals, convert.df_from_arrays(np.asarray(vj.hi),
                                            np.asarray(vj.lo), device="cpu"),
            At.offsets, degree, lo, hi))
        assert np.abs(got - ref).max() <= 1e-11 * np.abs(ref).max()
        return
    v = v.astype(dtype)
    ref = np.asarray(jcheby.cheby_apply(lambda u: jspmv(A, u),
                                        jnp.asarray(v), degree, lo, hi))
    if dtype == "float64":
        op = convert.cheby_operator_from_arrays(
            "dia", {"vals": np.asarray(A.vals)},
            {"offsets": A.offsets, "n": n}, degree, lo, hi, device="cpu")
        got = op.apply(torch.from_numpy(v)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max())
        return
    got = cc.cheby_chain_plain(At.vals, torch.from_numpy(v), At.offsets,
                               degree, lo, hi).numpy()
    assert np.abs(got - ref).max() <= 2e-6 * np.abs(ref).max()


def test_chain_is_linear():
    """p(A) is a fixed linear operator (what the exit transform x = p(A) y
    relies on): additivity and homogeneity to rounding, as the JAX test
    holds its chain."""
    n = 4096
    _, At, (lo, hi) = _operator(n, "float64")
    op = tcheby.ChebyOperator(At, 4, lo, hi)
    rng = np.random.default_rng(0)
    u, v = (torch.from_numpy(rng.standard_normal(n)) for _ in range(2))
    np.testing.assert_allclose(op.apply(u + 2.0 * v).numpy(),
                               (op.apply(u) + 2.0 * op.apply(v)).numpy(),
                               rtol=1e-10, atol=1e-12)


def test_operator_routes_and_fused_gates():
    """A ChebyOperator is no DiaMatrix: every fused route's format_ok
    refuses it, so the solve takes the unfused solver, whose p(A) is the
    chain kernel's wrapper on a float32 or DF DIA band and cheby_apply over
    layout.spmv on float64 and ELL; the chain gate takes every square
    DIA band at any degree up to the kernel's limit."""
    _, A32, (lo, hi) = _operator(512, "float32")
    _, Adf, _ = _operator(512, "df32")
    _, A64, _ = _operator(512, "float64")
    for A in (A32, Adf):
        op = tcheby.ChebyOperator(A, 8, lo, hi)
        assert op.shape == A.shape and op.device == A.device
        assert not fcl.format_ok(op, torch.float32)
        assert not fcldf.format_ok(op, torch.float32)
        assert not cbs.format_ok(op, torch.float32, 2)
        assert cc.format_ok(A, torch.float32, 8)
        assert cc.format_ok(A, torch.float32, cc.MAX_DEGREE)
        assert not cc.format_ok(A, torch.float32, cc.MAX_DEGREE + 1)
    assert not cc.format_ok(A64, torch.float64, 8)
    ell = build_operator(tgen.transport_hard(512), format="ell",
                         dtype=torch.float32, device="cpu")
    assert not cc.format_ok(ell, torch.float32, 8)
    calls = []
    real = {"f32": cc.cheby_chain, "df": cc.cheby_chain_df}
    with pytest.MonkeyPatch.context() as mp:
        for key, name in (("f32", "cheby_chain"), ("df", "cheby_chain_df")):
            mp.setattr(cc, name, lambda *a, _k=key: calls.append(_k)
                       or real[_k](*a))
        x = torch.ones(512)
        for A, key in ((A32, "f32"), (ell, None), (A64, None)):
            calls.clear()
            tcheby.ChebyOperator(A, 3, lo, hi).apply(
                x.double() if A is A64 else x)
            assert calls == ([key] if key else [])
        calls.clear()
        tcheby.ChebyOperator(Adf, 3, lo, hi).apply(tp.DF(x, torch.zeros(512)))
        assert calls == ["df"]


# --- preconditioned solves ---------------------------------------------------

F64_FIXTURE = (2048, [1, -1, 9, -9], 3)
DEGREE = 3


@functools.cache
def _fixture(dtype, n=F64_FIXTURE[0]):
    _, offsets, seed = F64_FIXTURE
    csr_j = jgen.banded_random(n, offsets, seed=seed)
    pj = jprob.build_problem(csr_j, dtype=dtype if dtype == "df32" else
                             jnp.float64, multiple=1)
    pt = tprob.build_problem(tgen.banded_random(n, offsets, seed=seed),
                             dtype=dtype, multiple=1, device="cpu")
    lo, hi = tcheby.estimate_bounds(pt.csr)
    return pj, pt, lo, hi


@pytest.mark.parametrize("method", ["bicgstab", "ca_bicgstab",
                                    "pipe_bicgstab", "pipe_bicgstab_rr"])
def test_f64_preconditioned_solve_matches_jax(method):
    pj, pt, lo, hi = _fixture("float64")
    rj = japi.solve(pj.A, pj.b, method=method, cfg=jcfg.SolverConfig(
        tol=1e-10, max_iter=300, dtype=jnp.float64),
        precond=jcheby.ChebyPrecond(DEGREE, lo, hi))
    rt = tapi.solve(pt.A, pt.b, method=method,
                    cfg=SolverConfig(tol=1e-10, max_iter=300),
                    precond=tcheby.ChebyPrecond(DEGREE, lo, hi))
    assert bool(rt.converged) and bool(rj.converged)
    assert abs(rt.n_iter - int(rj.n_iter)) <= 2
    k = min(rt.n_iter, int(rj.n_iter))
    np.testing.assert_allclose(rt.history[:k].numpy(),
                               np.asarray(rj.history)[:k], rtol=1e-6)
    assert float((rt.x - 1.0).abs().max()) < 1e-6
    # x = p(A) y at exit: the residual fields are the original system's
    r = pt.b - torch.from_numpy(pt.csr.matvec(rt.x.numpy()))
    assert float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(
        pt.b)) < 1e-8


@pytest.mark.parametrize("method", ["bicgstab", "pipe_bicgstab"])
def test_df32_preconditioned_solve_matches_jax(method):
    """df32 at degree 2: the port's DF chain twin (and, for pipe_bicgstab,
    its fused DF bodies) against the JAX package's unfused DF route."""
    pj, pt, lo, hi = _fixture("df32", 512)   # the JAX DF compile is long
    rj = japi.solve(pj.A, pj.b, method=method, cfg=jcfg.SolverConfig(
        tol=1e-11, max_iter=300, dtype="df32", restarts=0),
        precond=jcheby.ChebyPrecond(2, lo, hi))
    rt = tapi.solve(pt.A, pt.b, method=method,
                    cfg=SolverConfig(tol=1e-11, max_iter=300, dtype="df32",
                                     restarts=0),
                    precond=tcheby.ChebyPrecond(2, lo, hi))
    assert bool(rt.converged) and bool(rj.converged)
    assert abs(rt.n_iter - int(rj.n_iter)) <= 2
    assert tp.is_df(rt.x)
    assert np.abs(tp.df_to_f64(rt.x) - 1.0).max() < 1e-8
    assert np.abs(jp.df_to_f64(rj.x) - 1.0).max() < 1e-8


def test_solve_batched_with_precond_matches_jax():
    """Lane by lane with one exit transform per lane, as JAX's vmap."""
    pj, pt, lo, hi = _fixture("float64")
    rng = np.random.default_rng(2)
    B = np.stack([pt.csr.matvec(np.ones(pt.n)),
                  pt.csr.matvec(rng.standard_normal(pt.n))])
    rj = japi.solve_batched(pj.A, B, cfg=jcfg.SolverConfig(
        tol=1e-10, max_iter=300, dtype=jnp.float64),
        precond=jcheby.ChebyPrecond(DEGREE, lo, hi))
    rt = tapi.solve_batched(pt.A, torch.from_numpy(B),
                            cfg=SolverConfig(tol=1e-10, max_iter=300),
                            precond=tcheby.ChebyPrecond(DEGREE, lo, hi))
    assert rt.converged.all() and np.asarray(rj.converged).all()
    assert np.abs(rt.n_iter.numpy() - np.asarray(rj.n_iter)).max() <= 2
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-8)
    assert float((rt.x[0] - 1.0).abs().max()) < 1e-6


def test_restarts_run_in_the_preconditioned_space():
    """A float32 preconditioned solve asked for more than float32 can
    attain ends in the restart policy, whose segments re-enter the solver
    in y; the exit transform runs once, after them."""
    pt = tprob.build_problem(tgen.banded_random(4000, [1, -1, 60, -60],
                                                seed=9),
                             dtype="float32", device="cpu")
    lo, hi = tcheby.estimate_bounds(pt.csr)
    applied = []
    real = cc.cheby_chain
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cc, "cheby_chain",
                   lambda *a: applied.append(1) or real(*a))
        res = tapi.solve(pt.A, pt.b, cfg=SolverConfig(
            tol=1e-9, max_iter=300, dtype="float32", restarts=2),
            precond=tcheby.ChebyPrecond(2, lo, hi))
    h = res.history.numpy()
    assert np.isfinite(h[:res.n_iter]).all()
    assert np.isnan(h[res.n_iter:]).all()
    # 2 applications per iteration, 2 per segment (r0, true residual), 1 exit
    segs = (len(applied) - 1 - 2 * res.n_iter) // 2
    assert len(applied) == 2 * res.n_iter + 2 * segs + 1 and segs >= 2


# --- the CLI -----------------------------------------------------------------

def test_cli_precond_matches_jax_cli():
    base = ["solve", "--matrix", "transport-hard:512", "--tol", "1e-10"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jcode = jcli.main([*base, "--precond", "cheby:4", "--platform",
                           "cpu", "--json"])
    want = json.loads(out.getvalue().strip().splitlines()[-1])
    got, res = cli.run_solve(cli.build_parser().parse_args(
        [*base, "--precond", "cheby:4", "--device", "cpu"]))
    assert jcode == 0 and want["converged"] and got["converged"]
    assert got["precond"] == want["precond"] == "cheby:4:0.121:1210.0"
    assert abs(got["total_iter"] - want["total_iter"]) <= 2
    assert float((res.x - 1.0).abs().max()) < 1e-6
    with pytest.raises(SystemExit, match="unknown preconditioner"):
        cli.main([*base, "--precond", "ilu", "--device", "cpu"])
    with pytest.raises(SystemExit, match="degree"):
        cli.main([*base, "--precond", "cheby:0", "--device", "cpu"])


def test_cli_iteration_hint_and_rhs_batch(tmp_path):
    """The >= 1000-iteration hint goes to stderr without --precond only;
    --rhs-batch takes --precond."""
    args = ["solve", "--matrix", "banded:512", "--tol", "0", "--max-iter",
            "1000", "--device", "cpu"]
    for extra, hinted in (((), True), (("--precond", "cheby:1"), False)):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            report, _ = cli.run_solve(cli.build_parser().parse_args(
                [*args, *extra]))
        assert report["total_iter"] == 1000
        assert ("--precond cheby:8" in err.getvalue()) == hinted
    csr, _ = cli._load_matrix("banded:512")
    path = tmp_path / "B.npy"
    np.save(path, np.stack([csr.matvec(np.ones(512)),
                            csr.matvec(np.linspace(0.0, 1.0, 512))]))
    report, res = cli.run_solve(cli.build_parser().parse_args(
        ["solve", "--matrix", "banded:512", "--rhs-batch", str(path),
         "--precond", "cheby:3", "--tol", "1e-10", "--device", "cpu"]))
    assert all(report["converged"]) and report["batch"] == 2
    assert float((res.x[0] - 1.0).abs().max()) < 1e-8


# --- chip_smoke's phases of this slice ---------------------------------------

@functools.cache
def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE_N = 512      # transport_hard(512) is the 8^3 grid


@pytest.mark.parametrize("phase", ["cheby", "cheby_df32", "cheby_pipe_df32",
                                   "cheby_f64", "cheby_batched",
                                   "pipe_df32_ell", "cheby_ab"])
def test_chip_smoke_cheby_phases_on_cpu(phase, capsys):
    """chip_smoke's Chebyshev and DF-bodies phases at a small n on the
    CPU: each ends converged with its true residual <= 100 tol (the phase
    raises otherwise) and counts no kernel launch (plain twins only); the
    A/B's preconditioned solve converges."""
    smoke = _chip_smoke()
    p64 = tprob.build_problem(tgen.transport_hard(SMOKE_N),
                              dtype=torch.float64, multiple=1, device="cpu")
    inp = smoke.cheby_inputs(p64, device="cpu")
    prec = tcheby.ChebyPrecond(smoke.CHEBY_DEGREE, inp["h_lo"], inp["h_hi"])
    if phase == "cheby":
        smoke.run_cheby_cli(SMOKE_N, device="cpu")
    elif phase in smoke.CHEBY_PATHS:
        smoke.run_cheby_api(phase, {"float32": inp["h_prob32"],
                                    "df32": inp["h_probdf"], "float64": p64},
                            prec, device="cpu")
    elif phase == "cheby_batched":
        smoke.run_cheby_batched(inp["h_prob32"], prec, device="cpu")
    elif phase == "cheby_ab":
        smoke.run_cheby_ab({"float32": inp["h_prob32"],
                            "df32": inp["h_probdf"]}, prec)
    else:
        csr = tgen.transport_like(8192)
        pdf = tprob.build_problem(csr, dtype="df32", multiple=1, device="cpu")
        it = tapi.solve(pdf.A, pdf.b, method="pipe_bicgstab",
                        cfg=SolverConfig(tol=1e-10, dtype="df32")).n_iter
        smoke.run_pipe_df32_ell(csr, pdf.b, it, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"[{phase}] ")
    assert ("cheby_converged=True" if phase == "cheby_ab"
            else "launches={}") in line


def _cheby_counts(**kw):
    base = dict.fromkeys(("dia_spmv", "dia_spmv_df", "fused_k1",
                          "fused_k1_df", "fused_body_a", "fused_body_b",
                          "cheby_chain", "cheby_chain_df"), 0)
    return {**base, **kw}


@pytest.mark.parametrize("method,dtype,it,lanes,counts,ok", [
    # float32 classic, one segment: 2 (chain + SpMV) per iteration, 2 per
    # segment, and the exit transform's chain
    ("bicgstab", "float32", 235, 1, _cheby_counts(dia_spmv=472,
                                                  cheby_chain=473), True),
    ("bicgstab", "float32", 235, 1, _cheby_counts(dia_spmv=472,
                                                  cheby_chain=472), False),
    ("bicgstab", "float32", 235, 1, _cheby_counts(
        dia_spmv=472, cheby_chain=473, fused_k1=1), False),
    # four segments with restarts = 2
    ("bicgstab", "float32", 10, 1, _cheby_counts(dia_spmv=28,
                                                 cheby_chain=29), False),
    # df32 pipelined: w0 and t0 too, and the bodies once per iteration
    ("pipe_bicgstab", "df32", 223, 1, _cheby_counts(
        dia_spmv_df=450, cheby_chain_df=451, fused_body_a=223,
        fused_body_b=223), True),
    ("pipe_bicgstab", "df32", 223, 1, _cheby_counts(
        dia_spmv_df=450, cheby_chain_df=451, fused_body_a=223,
        fused_body_b=222), False),
    ("bicgstab", "df32", 229, 1, _cheby_counts(dia_spmv_df=460,
                                               cheby_chain_df=461), True),
    # float64: every p(A) is degree SpMVs
    ("bicgstab", "float64", 224, 1, _cheby_counts(dia_spmv=9 * 450 + 8),
     True),
    ("bicgstab", "float64", 224, 1, _cheby_counts(dia_spmv=9 * 450 + 7),
     False),
    # two lanes, one segment each, one exit transform each
    ("bicgstab", "float32", 235 + 18, 2, _cheby_counts(dia_spmv=510,
                                                       cheby_chain=512),
     True),
])
def test_chip_smoke_cheby_launch_rule(method, dtype, it, lanes, counts, ok):
    """The launch counts chip_smoke accepts for a preconditioned run on
    the card (degree 8, restarts = 2: up to 3 segments per lane) follow
    from the solvers' code."""
    smoke = _chip_smoke()
    assert smoke.CHEBY_DEGREE == 8
    check = functools.partial(smoke.check_cheby_counts, "rule", method, dtype,
                              it, counts, 2, lanes=lanes)
    if ok:
        check()
    else:
        with pytest.raises(smoke.SmokeFailure):
            check()
