"""Port vs JAX package: the df32 (double-float) classic path — the DF
SpMV and layouts, the plain twins of the fused DF passes K1, K2, K3, and
df32 solves through api.solve.

The twins (what the port's wrappers run for CPU tensors) are held to the
JAX package's XLA expressions for the same quantities (vfma,
dia_spmv_df, df_dot on a JAX DF operator carried across), as
tests/test_fused_pipe.py holds the JAX DF kernels; the JAX DF Pallas
kernels are not run here (in interpret mode they are slow). Tolerances:
vectors rtol = atol = 1e-12, SpMV outputs 1e-11, dots within 1e-12
sum |u_i v_i|, folded scalars 1e-13 relative of their formula on the
port's own dots. Solves at tol 1e-11: n_iter within +-2 of JAX's, both
converged, max|x-1| < 1e-8, and the df32 true residual at least 1e3
below the float32 solve's.
"""
import contextlib
import functools
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.api as japi
import mpi_bicgstab_tpu.models.generators as jgen
import mpi_bicgstab_tpu.models.problem as jprob
import mpi_bicgstab_tpu.ops.dia as jdia
import mpi_bicgstab_tpu.ops.layout as jlayout
import mpi_bicgstab_tpu.ops.precision as jp
import mpi_bicgstab_tpu.ops.sparse as jsparse
import mpi_bicgstab_tpu.utils.config as jcfg
import mpi_bicgstab_tpu_torch.api as tapi
import mpi_bicgstab_tpu_torch.models.generators as tgen
import mpi_bicgstab_tpu_torch.models.problem as tprob
import mpi_bicgstab_tpu_torch.ops.cuda_fused_classic as tfcl
import mpi_bicgstab_tpu_torch.ops.cuda_fused_classic_df as tfd
import mpi_bicgstab_tpu_torch.ops.cuda_spmv as tspmv
import mpi_bicgstab_tpu_torch.ops.dia as tdia
import mpi_bicgstab_tpu_torch.ops.layout as tlayout
import mpi_bicgstab_tpu_torch.ops.precision as tp
from mpi_bicgstab_tpu_torch import cli, convert
from mpi_bicgstab_tpu_torch.parallel.comm import Comm
from mpi_bicgstab_tpu_torch.solvers.bicgstab import CLASSIC_SOLVERS
from mpi_bicgstab_tpu_torch.utils.config import SolverConfig

torch.set_num_threads(1)

CASES = {
    "narrow": (4096, [1, -1, 40, -40, 129, -129], 11),
    "wide": (4096, [1, -1, 3000, -3000], 7),       # most rows skip a column
    "n1000": (1000, [1, -1, 30, -30], 13),
}


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
    rng = np.random.default_rng(4)
    jv = {k: jp.df_from_f64(rng.standard_normal(n))
          for k in ("r", "p", "s", "rh", "x", "q", "y")}
    jv.update({k: jp.df_from_f64(np.float64(v)) for k, v in
               (("be", 0.3), ("om", 0.2), ("al", 0.7), ("rtr", 2.5))})
    return A, At, jv, {k: _carry(v) for k, v in jv.items()}


def _vec(got, want, tol):
    np.testing.assert_allclose(_t(got), _j(want), rtol=tol, atol=tol)


def _dot(got, want, u, v):
    scale = np.abs(_j(u) * _j(v)).sum()
    assert abs(float(_t(got)) - float(_j(want))) <= 1e-12 * scale


def test_df_operator_carried_across_is_the_ports_own():
    n, offsets, seed = CASES["narrow"]
    A, At, _, _ = _setup("narrow")
    own = tprob.build_problem(tgen.banded_random(n, offsets, seed=seed),
                              dtype="df32", multiple=1, device="cpu").A
    assert tp.is_df(own.vals) and own.offsets == At.offsets
    assert own.dtype == torch.float32 and own.device.type == "cpu"
    assert torch.equal(own.vals.hi, At.vals.hi)
    assert torch.equal(own.vals.lo, At.vals.lo)


@pytest.mark.parametrize("case", list(CASES))
def test_dia_spmv_df_matches_jax(case):
    A, At, jv, tv = _setup(case)
    want = jdia.dia_spmv_df(A, jv["x"])
    got = tspmv.dia_spmv_df(At.vals, At.offsets, tv["x"])   # CPU: the twin
    _vec(got, want, 1e-11)
    for other in (tlayout.spmv(At, tv["x"]), tdia.dia_spmv_df(At, tv["x"]),
                  tspmv.dia_spmv_df_plain(At.vals, At.offsets, tv["x"])):
        assert torch.equal(other.hi, got.hi)
        assert torch.equal(other.lo, got.lo)


@pytest.mark.parametrize("case", list(CASES))
def test_k1_df_twin_matches_jax(case):
    A, At, jv, tv = _setup(case)
    p2x = jp.vfma(jv["r"], jv["be"], jp.vfma(jv["p"], -jv["om"], jv["s"]))
    s2x = jdia.dia_spmv_df(A, p2x)
    p2, s2, rhTs, alpha = tfd.fused_k1_df(
        At.vals, tv["r"], tv["p"], tv["s"], tv["rh"],
        (tv["be"], tv["om"], tv["rtr"]), At.offsets)
    _vec(p2, p2x, 1e-12)
    _vec(s2, s2x, 1e-11)
    _dot(rhTs, jp.df_dot(jv["rh"], s2x), jv["rh"], s2x)
    np.testing.assert_allclose(float(alpha), 2.5 / float(rhTs), rtol=1e-13)


@pytest.mark.parametrize("case", list(CASES))
def test_k2_df_twin_matches_jax(case):
    A, At, jv, tv = _setup(case)
    qx = jp.vfma(jv["r"], -jv["al"], jv["s"])
    yx = jdia.dia_spmv_df(A, qx)
    q, y, qTy, yTy, omega = tfd.fused_k2_df(At.vals, tv["r"], tv["s"],
                                            (tv["al"],), At.offsets)
    _vec(q, qx, 1e-12)
    _vec(y, yx, 1e-11)
    _dot(qTy, jp.df_dot(qx, yx), qx, yx)
    _dot(yTy, jp.df_dot(yx, yx), yx, yx)
    np.testing.assert_allclose(float(omega), float(qTy) / float(yTy),
                               rtol=1e-13)


@pytest.mark.parametrize("case", list(CASES))
def test_k3_df_twin_matches_jax(case):
    _, _, jv, tv = _setup(case)
    x2x = jp.vfma(jp.vfma(jv["x"], jv["al"], jv["p"]), jv["om"], jv["q"])
    r2x = jp.vfma(jv["q"], -jv["om"], jv["y"])
    x2, r2, dot_r, rTr, beta = tfd.fused_k3_df(
        tv["x"], tv["p"], tv["q"], tv["y"], tv["rh"],
        (tv["al"], tv["om"], tv["rtr"]))
    _vec(x2, x2x, 1e-12)
    _vec(r2, r2x, 1e-12)
    _dot(dot_r, jp.df_dot(r2x, r2x), r2x, r2x)
    _dot(rTr, jp.df_dot(jv["rh"], r2x), jv["rh"], r2x)
    np.testing.assert_allclose(float(beta),
                               (0.7 / 0.2) * (float(rTr) / 2.5), rtol=1e-13)


def test_wrappers_count_nothing_on_the_cpu():
    A, At, _, tv = _setup("n1000")
    fns = (tfd.fused_k1_df, tfd.fused_k2_df, tfd.fused_k3_df,
           tspmv.dia_spmv_df)
    before = [f.launches for f in fns]
    tfd.fused_k2_df(At.vals, tv["r"], tv["s"], (tv["al"],), At.offsets)
    tspmv.dia_spmv_df(At.vals, At.offsets, tv["x"])
    assert [f.launches for f in fns] == before


# --- layouts ------------------------------------------------------------------

def _stragglers(sparse_mod, csr, k, seed):
    """csr plus k random off-band entries."""
    rng = np.random.default_rng(seed)
    n = csr.nrows
    rows = np.repeat(np.arange(n), csr.row_lengths)
    r, c = rng.integers(0, n, k), rng.integers(0, n, k)
    return sparse_mod.coo_to_csr(sparse_mod.COOMatrix(
        np.concatenate([rows, r]), np.concatenate([csr.col, c]),
        np.concatenate([csr.val, rng.uniform(-1, 1, k)]), csr.shape),
        sum_duplicates=True)


def _df_arrays(op, prefix=""):
    """The leaves of a JAX DF layout, as convert takes them."""
    if isinstance(op, jdia.DiaMatrix):
        return {prefix + "vals_hi": np.asarray(op.vals.hi),
                prefix + "vals_lo": np.asarray(op.vals.lo)}
    out = {prefix + k: np.asarray(getattr(op, k))
           for k in ("cols", "tail_rows", "tail_cols")}
    for k in ("vals", "tail_vals"):
        out[f"{prefix}{k}_hi"] = np.asarray(getattr(op, k).hi)
        out[f"{prefix}{k}_lo"] = np.asarray(getattr(op, k).lo)
    return out


@pytest.mark.parametrize("kind,fmt,cls", [
    ("dia", "auto", "DiaMatrix"), ("hybrid", "auto", "HybridMatrix"),
    ("dia", "ell", "EllMatrix")])
def test_df_layout_spmv_matches_jax(kind, fmt, cls):
    base = (2000, [1, -1, 50, -50], 4)
    csr_j = jgen.banded_random(*base[:2], seed=base[2])
    csr_t = tgen.banded_random(*base[:2], seed=base[2])
    if kind == "hybrid":
        csr_j = _stragglers(jsparse, csr_j, 300, 5)
        from mpi_bicgstab_tpu_torch.ops import sparse as tsparse
        csr_t = _stragglers(tsparse, csr_t, 300, 5)
    opj = jlayout.build_operator(csr_j, format=fmt, dtype="df32",
                                 cache_dir="off")
    own = tlayout.build_operator(csr_t, format=fmt, dtype="df32",
                                 device="cpu")
    assert type(opj).__name__ == type(own).__name__ == cls
    if cls == "DiaMatrix":
        carried = convert.operator_from_arrays(
            "dia", _df_arrays(opj), {"offsets": opj.offsets,
                                     "n": opj.n_rows}, device="cpu")
    elif cls == "HybridMatrix":
        arrays = {**_df_arrays(opj.dia, "dia_"), **_df_arrays(opj.ell,
                                                              "ell_")}
        carried = convert.operator_from_arrays(
            "hybrid", arrays, {"offsets": opj.dia.offsets,
                               "n": opj.dia.n_rows}, device="cpu")
        assert own.ell.tail_size == carried.ell.tail_size
    else:
        carried = convert.operator_from_arrays(
            "ell", _df_arrays(opj), {"n_rows": opj.n_rows,
                                     "n_cols": opj.n_cols}, device="cpu")
    x64 = np.random.default_rng(7).standard_normal(csr_t.nrows)
    want = _j(jlayout.spmv(opj, jp.df_from_f64(x64)))
    for op in (carried, own):
        y = tlayout.spmv(op, tp.df_from_f64(x64))
        assert tp.is_df(y) and op.dtype == torch.float32
        np.testing.assert_allclose(_t(y), want, rtol=1e-11, atol=1e-11)


# --- solves -----------------------------------------------------------------

SOLVES = [(2048, [1, -1, 16, -16], 5), (4096, [1, -1, 16, -16], 6)]
TOL = 1e-11


@functools.cache
def _jax_solve(n, offsets, seed, method):
    csr = jgen.banded_random(n, list(offsets), seed=seed)
    pj = jprob.build_problem(csr, dtype="df32", multiple=1)
    res = japi.solve(pj.A, pj.b, method=method, cfg=jcfg.SolverConfig(
        tol=TOL, max_iter=400, dtype="df32"))
    return int(res.n_iter), bool(res.converged), _j(res.x)


def _port_problem(n, offsets, seed, dtype="df32"):
    return tprob.build_problem(tgen.banded_random(n, list(offsets),
                                                  seed=seed),
                               dtype=dtype, multiple=1, device="cpu")


def _check_like_jax(res, n, offsets, seed, method="bicgstab"):
    k, conv, xj = _jax_solve(n, tuple(offsets), seed, method)
    assert conv and bool(res.converged)
    assert abs(res.n_iter - k) <= 2, (res.n_iter, k)
    assert np.abs(xj - 1.0).max() < 1e-8
    assert np.abs(_t(res.x) - 1.0).max() < 1e-8
    hist = res.history.numpy()
    assert res.history.dtype == torch.float32
    assert np.isfinite(hist[:res.n_iter]).all()
    assert np.isnan(hist[res.n_iter:]).all()


@pytest.mark.parametrize("n,offsets,seed", SOLVES)
def test_df32_solve_matches_jax(n, offsets, seed):
    pt = _port_problem(n, offsets, seed)
    assert tp.is_df(pt.b) and tp.is_df(pt.x0)
    assert tfd.format_ok(pt.A, torch.float32)
    res = tapi.solve(pt.A, pt.b, cfg=SolverConfig(tol=TOL, max_iter=400,
                                                  dtype="df32"))
    assert tp.is_df(res.x) and res.x.shape == (n,)
    _check_like_jax(res, n, offsets, seed)


@pytest.mark.parametrize("n,offsets,seed", SOLVES)
def test_df32_true_residual_beats_float32(n, offsets, seed):
    """The flagship property (JAX tests/test_precision.py): df32's true
    residual goes orders of magnitude below float32's floor."""
    cfg = SolverConfig(tol=TOL, max_iter=400, restarts=0)
    rel = {}
    for dt in ("float32", "df32"):
        pt = _port_problem(n, offsets, seed, dt)
        res = tapi.solve(pt.A, pt.b, cfg=cfg.replace(dtype=dt))
        x = _t(res.x) if dt == "df32" else res.x.double().numpy()
        b = _t(pt.b) if dt == "df32" else pt.b.double().numpy()
        rel[dt] = np.linalg.norm(b - pt.csr.matvec(x)) / np.linalg.norm(b)
    assert rel["df32"] < 1e-11, rel
    assert (not np.isfinite(rel["float32"])) \
        or rel["df32"] < rel["float32"] * 1e-3, rel


def test_df32_bicgstab_l2_matches_jax():
    n, offsets, seed = SOLVES[0]
    pt = _port_problem(n, offsets, seed)
    res = tapi.solve(pt.A, pt.b, method="bicgstab_l2",
                     cfg=SolverConfig(tol=TOL, max_iter=400, dtype="df32"))
    # BiCGStab(l) writes every l-th history slot
    hist = res.history.numpy()
    assert np.isfinite(hist[1:res.n_iter:2]).all()
    k, conv, xj = _jax_solve(n, tuple(offsets), seed, "bicgstab_l2")
    assert conv and bool(res.converged) and abs(res.n_iter - k) <= 2
    assert np.abs(_t(res.x) - 1.0).max() < 1e-8 and \
        np.abs(xj - 1.0).max() < 1e-8


def test_df32_out_iter_route_matches_jax(capsys):
    """out_iter != 0 takes the unfused solver (where the residual print
    lives), as the JAX dispatch does; on the CPU the JAX package runs
    its unfused solver for either setting."""
    n, offsets, seed = SOLVES[0]
    pt = _port_problem(n, offsets, seed)
    res = tapi.solve(pt.A, pt.b, cfg=SolverConfig(tol=TOL, max_iter=400,
                                                  dtype="df32", out_iter=4))
    lines = capsys.readouterr().out.splitlines()
    assert lines and lines[0].startswith("iter 4: relres ")
    assert len(lines) == res.n_iter // 4
    _check_like_jax(res, n, offsets, seed)


def test_fused_df_route_equals_the_unfused_solver_on_the_cpu():
    """On the CPU the fused route's twins take the unfused solver's DF
    operation sequence: same iterations, same iterate to rounding."""
    n, offsets, seed = SOLVES[0]
    pt = _port_problem(n, offsets, seed)
    cfg = SolverConfig(tol=TOL, max_iter=400, dtype="df32")
    fused = tfd.bicgstab_fused_df(pt.A, pt.b, pt.x0, cfg)
    plain = CLASSIC_SOLVERS["bicgstab"](lambda v: tlayout.spmv(pt.A, v),
                                        Comm(), pt.b, pt.x0, cfg)
    assert fused.n_iter == plain.n_iter
    np.testing.assert_allclose(_t(fused.x), _t(plain.x), rtol=0,
                               atol=1e-13)
    assert bool(fused.converged) and bool(plain.converged)


def test_df32_routes(monkeypatch):
    """The df32 dispatch: classic, CA, pipelined and pipelined-RR on a DF
    DiaMatrix take their fused DF drivers (slices 3a and 3b) and
    converge; pipelined BiCGStab on any other layout and with out_iter
    runs its fused DF iteration bodies (slice 3c) and converges; the
    float32 fused route never takes DF values."""
    pt = _port_problem(1024, (1, -1, 9, -9), 3)
    cfg = SolverConfig(tol=1e-10, max_iter=200, krr=3, nrr=2, dtype="df32")
    assert not tfcl.format_ok(pt.A, torch.float32)
    assert not tfd.format_ok(pt.A, torch.float64)
    taken = []
    for method in ("ca_bicgstab", "pipe_bicgstab", "pipe_bicgstab_rr"):
        def spy(*args, _fn=tapi.FUSED_DF[method], _m=method):
            taken.append(_m)
            return _fn(*args)
        monkeypatch.setitem(tapi.FUSED_DF, method, spy)
        res = tapi.solve(pt.A, pt.b, method=method, cfg=cfg)
        assert taken[-1] == method and bool(res.converged), method
        assert np.abs(_t(res.x) - 1.0).max() < 1e-8
    with contextlib.redirect_stdout(io.StringIO()):
        res = tapi.solve(pt.A, pt.b, method="pipe_bicgstab",
                         cfg=cfg.replace(out_iter=4))
    assert bool(res.converged) and np.abs(_t(res.x) - 1.0).max() < 1e-8
    ell = tlayout.build_operator(pt.csr, format="ell", dtype="df32",
                                 device="cpu")
    assert not tfd.format_ok(ell, torch.float32)
    # pipelined on ELL: the fused bodies; CA and pipelined-RR: the
    # unfused DF solvers, as in the JAX package
    for method in ("pipe_bicgstab", "ca_bicgstab", "pipe_bicgstab_rr",
                   "bicgstab"):
        res = tapi.solve(ell, pt.b, method=method, cfg=cfg)
        assert bool(res.converged), method
        assert np.abs(_t(res.x) - 1.0).max() < 1e-7


def test_cli_df32_on_cpu(tmp_path):
    sol = tmp_path / "x.npy"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli.main(["solve", "--matrix", "banded:4096", "--dtype",
                         "df32", "--tol", "1e-11", "--device", "cpu",
                         "--write-solution", str(sol)])
    fields = {k.strip(): v.strip() for k, v in
              (line.split(":", 1) for line in out.getvalue().splitlines())}
    assert code == 0 and fields["converged"] == "True"
    assert float(fields["true_relres"]) < 1e-9
    x = np.load(sol)
    assert x.dtype == np.float64 and x.shape == (4096,)
    assert np.abs(x - 1.0).max() < 1e-8


def test_cli_df32_rhs_file(tmp_path):
    n = 1000
    rhs = tmp_path / "b.npy"
    b = np.linspace(1.0, 2.0, n) + 1e-9 * np.arange(n)   # beyond float32
    np.save(rhs, b)
    sol = tmp_path / "x.npy"
    with contextlib.redirect_stdout(io.StringIO()):
        code = cli.main(["solve", "--matrix", "banded:1000", "--dtype",
                         "df32", "--tol", "1e-12", "--device", "cpu",
                         "--rhs", str(rhs), "--write-solution", str(sol)])
    assert code == 0
    csr, _ = cli._load_matrix("banded:1000")
    x = np.load(sol)
    assert np.linalg.norm(b - csr.matvec(x)) / np.linalg.norm(b) < 1e-10
