"""Port vs JAX package: the float64 solve, the tol=0 contract, the entry
points' device rule, the CLI and chip_smoke's solve phase (on the CPU).

float64 solves: n_iter within +-2 of JAX's api.solve, the residual
history within rtol 1e-6 over the common prefix, the same `converged`,
and true_relres within a factor 10 of JAX's (both at the same tolerance
gate; the values themselves are rounding-level residues). The matrices
are the diagonally dominant kind BiCGStab converges on smoothly; on slow,
erratic systems (poisson2d, transport_hard) a last-bit difference in a
dot moves the iteration count by more than 2 in either package.
"""
import contextlib
import importlib.util
import io
import runpy
import sys
from pathlib import Path

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
from mpi_bicgstab_tpu_torch.utils.config import SolverConfig

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]

F64_CASES = [
    ("banded", lambda g: g.banded_random(6000, [1, -1, 18, -18, 330, -330],
                                         seed=2), "dia", 1e-10),
    ("transport_like", lambda g: g.transport_like(4096, seed=1), "dia",
     1e-12),
    ("banded_ell", lambda g: g.banded_random(3000, [1, -1, 50, -50],
                                             seed=5), "ell", 1e-10),
]


@pytest.mark.parametrize("name,gen,fmt,tol", F64_CASES,
                         ids=[c[0] for c in F64_CASES])
def test_f64_solve_matches_jax(name, gen, fmt, tol):
    pj = jprob.build_problem(gen(jgen), dtype=jnp.float64, format=fmt)
    rj = japi.solve(pj.A, pj.b, method="bicgstab",
                    cfg=jcfg.SolverConfig(tol=tol, max_iter=500,
                                          dtype=jnp.float64))
    pt = tprob.build_problem(gen(tgen), dtype="float64", format=fmt,
                             device="cpu")
    rt = tapi.solve(pt.A, pt.b, cfg=SolverConfig(tol=tol, max_iter=500))
    assert abs(rt.n_iter - int(rj.n_iter)) <= 2
    k = min(rt.n_iter, int(rj.n_iter))
    np.testing.assert_allclose(rt.history[:k].numpy(),
                               np.asarray(rj.history)[:k], rtol=1e-6)
    assert bool(rt.converged) == bool(rj.converged)
    assert bool(rt.converged)
    ratio = float(rt.true_relres) / float(rj.true_relres)
    assert 0.1 < ratio < 10.0, ratio
    assert float((rt.x - 1.0).abs().max()) < 1e-6


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_tol0_runs_exactly_max_iter(dtype):
    """tol == 0: exactly max_iter iterations, on the fused (float32) and
    the unfused (float64) route alike, even past the point where the
    recurrences break down on an easy system."""
    pt = tprob.build_problem(tgen.poisson2d(16), dtype=dtype, device="cpu")
    for max_iter in (1, 7, 60):
        res = tapi.solve(pt.A, pt.b, cfg=SolverConfig(
            tol=0.0, max_iter=max_iter, dtype=dtype))
        assert res.n_iter == max_iter
        assert res.history.shape == (max_iter,)


def test_restarts_report_total_iterations():
    """A float32 solve asked for more than float32 can attain ends in
    the restart policy, which keeps n_iter, history and relres in the
    units of the original r0 — as in the JAX package."""
    csr_t = tgen.banded_random(4000, [1, -1, 60, -60], seed=9)
    csr_j = jgen.banded_random(4000, [1, -1, 60, -60], seed=9)
    pt = tprob.build_problem(csr_t, dtype="float32", device="cpu")
    pj = jprob.build_problem(csr_j, dtype=jnp.float32)
    rt = tapi.solve(pt.A, pt.b, cfg=SolverConfig(tol=1e-9, max_iter=300,
                                                 dtype="float32"))
    rj = japi.solve(pj.A, pj.b, cfg=jcfg.SolverConfig(
        tol=1e-9, max_iter=300, dtype=jnp.float32))
    assert bool(rt.converged) == bool(rj.converged)
    h = rt.history.numpy()
    assert np.isfinite(h[:rt.n_iter]).all() and np.isnan(h[rt.n_iter:]).all()
    assert abs(rt.n_iter - int(rj.n_iter)) <= 6   # +-2 per segment


def test_out_iter_prints_and_takes_the_unfused_route(capsys):
    """cfg.out_iter != 0 prints the relative residual every out_iter
    iterations (DISPLAY_RESIDUAL) and so routes float32 off the fused
    passes, as the JAX dispatch does; the iterates agree."""
    pt = tprob.build_problem(tgen.transport_like(4096, seed=1),
                             dtype="float32", device="cpu")
    quiet = tapi.solve(pt.A, pt.b, cfg=SolverConfig(tol=1e-6,
                                                    dtype="float32"))
    loud = tapi.solve(pt.A, pt.b, cfg=SolverConfig(tol=1e-6, out_iter=2,
                                                   dtype="float32"))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("iter 2: relres ")
    assert len(lines) == loud.n_iter // 2
    assert abs(loud.n_iter - quiet.n_iter) <= 1
    assert bool(loud.converged) and bool(quiet.converged)


def test_entry_points_default_to_the_card():
    csr = tgen.poisson2d(8)
    if torch.cuda.is_available():
        assert tprob.build_problem(csr).b.is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprob.build_problem(csr)
    from mpi_bicgstab_tpu_torch import cli
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["solve", "--matrix", "banded:512"])


def test_unported_options_raise_naming_their_slice():
    pt = tprob.build_problem(tgen.poisson2d(8), device="cpu")
    # slice 2 is ported: pipe_bicgstab runs on the CPU now
    assert bool(tapi.solve(pt.A, pt.b, method="pipe_bicgstab",
                           cfg=SolverConfig(tol=1e-10)).converged)
    # slice 7 is ported: a Chebyshev preconditioner with bounds solves,
    # one without bounds and no host matrix to estimate them is refused
    from mpi_bicgstab_tpu_torch.ops.cheby import ChebyPrecond
    assert bool(tapi.solve(pt.A, pt.b, cfg=SolverConfig(tol=1e-10),
                           precond=ChebyPrecond(2, 0.08, 8.0)).converged)
    with pytest.raises(ValueError, match="bounds"):
        tapi.solve(pt.A, pt.b, precond=ChebyPrecond(2))
    # slices 3a, 3b and 3c are ported: df32 is a config dtype (float32, as
    # in JAX), df32 CA runs on a DF DiaMatrix, and df32 pipelined
    # BiCGStab with out_iter runs its fused DF iteration bodies
    assert SolverConfig(dtype="df32").dtype == torch.float32
    pdf = tprob.build_problem(tgen.poisson2d(8), dtype="df32", device="cpu")
    assert bool(tapi.solve(pdf.A, pdf.b, method="ca_bicgstab",
                           cfg=SolverConfig(tol=1e-10,
                                            dtype="df32")).converged)
    with contextlib.redirect_stdout(io.StringIO()):
        assert bool(tapi.solve(pdf.A, pdf.b, method="pipe_bicgstab",
                               cfg=SolverConfig(tol=1e-10, dtype="df32",
                                                out_iter=2)).converged)
    with pytest.raises(ValueError):
        tapi.solve(pt.A, pt.b, method="gmres")
    with pytest.raises(SystemExit):       # argparse refuses float16
        from mpi_bicgstab_tpu_torch import cli
        with contextlib.redirect_stderr(io.StringIO()):
            cli.main(["solve", "--matrix", "banded:512", "--dtype",
                      "float16"])


def _run_module(argv, monkeypatch):
    """`python -m mpi_bicgstab_tpu_torch <argv>` in this process (a fresh
    interpreter would spend the test's time budget importing torch)."""
    monkeypatch.setattr(sys, "argv", ["mpi_bicgstab_tpu_torch", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as ex:
        runpy.run_module("mpi_bicgstab_tpu_torch", run_name="__main__",
                         alter_sys=True)
    return ex.value.code, out.getvalue()


def test_cli_solve_on_cpu(monkeypatch, tmp_path):
    sol = tmp_path / "x.npy"
    code, out = _run_module(["solve", "--matrix", "banded:4096",
                             "--device", "cpu", "--write-solution",
                             str(sol)], monkeypatch)
    assert code == 0, out
    fields = dict(line.split(":", 1) for line in out.splitlines())
    fields = {k.strip(): v.strip() for k, v in fields.items()}
    assert fields["converged"] == "True"
    assert fields["method"] == "bicgstab" and fields["n"] == "4096"
    for key in ("total_iter", "final_relres", "true_relres",
                "total_time_s", "avg_time_per_iter_s", "io_time_s",
                "setup_s"):
        assert key in fields
    np.testing.assert_allclose(np.load(sol), 1.0, atol=1e-10)


def test_cli_rhs_from_matrix_market(monkeypatch, tmp_path):
    from mpi_bicgstab_tpu.io.mmio import write_matrix_market
    n = 512
    rhs = tmp_path / "b.mtx"
    write_matrix_market(str(rhs), np.arange(n), np.zeros(n, int),
                        np.linspace(1.0, 2.0, n), (n, 1))
    code, out = _run_module(["solve", "--matrix", "banded:512", "--rhs",
                             str(rhs), "--dtype", "float32", "--tol",
                             "1e-5", "--device", "cpu"], monkeypatch)
    assert code == 0, out


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("float64", 1e-10)])
def test_chip_smoke_solve_phase_on_cpu(dtype, tol):
    """chip_smoke's main-path phase at n = 8192 on the CPU: converged,
    max|x-1| within bounds, and no kernel counted (plain twins only)."""
    smoke = _chip_smoke()
    report, counts, err = smoke.run_main_path(8192, dtype, tol, "cpu")
    assert report["converged"] and report["n"] == 8192
    assert {"dia_spmv", "fused_k1", "fused_k2", "fused_k3"} <= set(counts)
    assert set(counts.values()) == {0}
    assert err < (1e-3 if dtype == "float32" else 1e-6)


def test_chip_smoke_refuses_without_a_card():
    smoke = _chip_smoke()
    if torch.cuda.is_available():
        pytest.skip("a card is present")   # decided here, not at import
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()) as out:
        assert smoke.main() != 0
    assert out.getvalue() == "" and "no CUDA device" in err.getvalue()


def _unstructured_mtx(tmp_path, n=2048, seed=0, wide_row=False):
    """A diagonally dominant .mtx with no band: 10 on the diagonal and up
    to 5 random off-diagonal entries per row (one diagonal holds ~17% of
    the nonzeros and its columns have no window locality, so 'auto'
    routes it to the butterfly layout). wide_row: row 0 also takes 40
    entries, wider than the butterfly's 24 slabs, so its build refuses
    the matrix and 'auto' lands on gather-ELL."""
    from mpi_bicgstab_tpu.io.mmio import write_matrix_market
    rng = np.random.default_rng(seed)
    rows, cols, vals = [np.arange(n)], [np.arange(n)], [np.full(n, 10.0)]
    for i in range(n):
        c = rng.choice(n, 40 if wide_row and i == 0 else rng.integers(0, 6),
                       replace=False)
        c = c[c != i]
        rows.append(np.full(c.size, i))
        cols.append(c)
        vals.append(rng.uniform(-1.0, 1.0, c.size) / (8 if i == 0 else 1))
    path = tmp_path / ("w.mtx" if wide_row else "u.mtx")
    write_matrix_market(str(path), np.concatenate(rows), np.concatenate(cols),
                        np.concatenate(vals), (n, n))
    return str(path)


def test_cli_format_ell_solves_an_unstructured_mtx(tmp_path):
    """--format ell solves an unstructured matrix as the JAX CLI does;
    --format window builds the windowed-ELL layout on the matrix padded to
    1024 rows (its tail holds the out-of-window entries) and solves it in
    the ell solve's iterations within 2; 'auto' and --format butterfly
    (the next test) now solve it too, where they exited naming the
    unported layout."""
    import json

    import mpi_bicgstab_tpu.cli as jcli
    from mpi_bicgstab_tpu_torch import cli
    mtx = _unstructured_mtx(tmp_path)
    base = ["solve", "--matrix", mtx, "--tol", "1e-10"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jcode = jcli.main([*base, "--format", "ell", "--platform", "cpu",
                           "--json"])
    want = json.loads(out.getvalue().strip().splitlines()[-1])
    got, _ = cli.run_solve(cli.build_parser().parse_args(
        [*base, "--format", "ell", "--device", "cpu"]))
    assert jcode == 0 and want["converged"] and got["converged"]
    assert abs(got["total_iter"] - want["total_iter"]) <= 2
    assert got["true_relres"] <= 100 * 1e-10
    win, _ = cli.run_solve(cli.build_parser().parse_args(
        [*base, "--format", "window", "--device", "cpu"]))
    assert win["layout"] == "WindowEllMatrix" and win["converged"]
    assert abs(win["total_iter"] - got["total_iter"]) <= 2
    # the shifted command takes the flag too
    rows, res = cli.run_solve_shifted(cli.build_parser().parse_args(
        ["solve-shifted", "--matrix", mtx, "--format", "ell",
         "--sigma-len", "4", "--seed", "3", "--tol", "1e-10",
         "--device", "cpu"]))
    assert rows[0]["all_converged"]


def test_cli_auto_and_butterfly_solve_an_unstructured_mtx(tmp_path):
    """'auto' routes the unstructured matrix to the butterfly layout, as
    JAX does, built on the matrix padded to 1024 rows, as is --format
    butterfly: both solve it, in solve and solve-shifted."""
    import mpi_bicgstab_tpu.models.problem as jprob
    import mpi_bicgstab_tpu.ops.sparse as jsparse
    from mpi_bicgstab_tpu_torch import cli
    mtx = _unstructured_mtx(tmp_path)
    pj = jprob.build_problem(jsparse.load_csr(mtx), multiple=1024)
    assert type(pj.A).__name__ == "ButterflyMatrix"
    iters = []
    for fmt in ("auto", "butterfly"):
        rep, _ = cli.run_solve(cli.build_parser().parse_args(
            ["solve", "--matrix", mtx, "--tol", "1e-10", "--format", fmt,
             "--device", "cpu"]))
        assert rep["layout"] == "ButterflyMatrix" and rep["converged"], fmt
        iters.append(rep["total_iter"])
    assert iters[0] == iters[1]
    rows, res = cli.run_solve_shifted(cli.build_parser().parse_args(
        ["solve-shifted", "--matrix", mtx, "--sigma-len", "4", "--seed",
         "3", "--tol", "1e-10", "--device", "cpu"]))
    assert rows[0]["all_converged"] and res.x_set.shape == (4, 2048)


def test_cli_auto_lands_on_gather_ell_when_butterfly_refuses(tmp_path):
    """A row of 40 entries: the butterfly build refuses the matrix (wider
    than its 24 slabs), so 'auto' lands on gather-ELL in both packages
    (JAX ops/layout.py:120-130, on the matrix padded to 1024 rows), and
    --format butterfly raises the build's error."""
    import mpi_bicgstab_tpu.models.problem as jprob
    import mpi_bicgstab_tpu.ops.sparse as jsparse
    from mpi_bicgstab_tpu_torch import cli
    mtx = _unstructured_mtx(tmp_path, n=2000, wide_row=True)
    pj = jprob.build_problem(jsparse.load_csr(mtx), multiple=1024)
    assert type(pj.A).__name__ == "EllMatrix" and pj.n == 2048
    got, res = cli.run_solve(cli.build_parser().parse_args(
        ["solve", "--matrix", mtx, "--tol", "1e-10", "--device", "cpu"]))
    assert got["layout"] == "EllMatrix" and got["converged"]
    assert res.x.shape == (2048,)
    with pytest.raises(ValueError, match="row width"):
        cli.main(["solve", "--matrix", mtx, "--format", "butterfly",
                  "--device", "cpu"])
