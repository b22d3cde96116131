"""The port's CLI surfaces against the JAX CLI (mpi_bicgstab_tpu/cli.py):
the `solve` flags --json, --repeat, --dump-history, --verbose-every,
--checkpoint / --checkpoint-every and their refusals; `solve-shifted`'s
--repeat, --json and --dump-history; the iterate checkpoint of
utils/checkpoint.py against the JAX package's solve_with_checkpoints; the
commands info, convert and selftest on the CPU; and
benchmarks/runner.run_bench with its timers stubbed.

Tolerances: the solvers' bar (ROADMAP): iterations within 2, float64
residuals and curves within rtol 1e-6.
"""
import contextlib
import io
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.api as japi
import mpi_bicgstab_tpu.benchmarks.runner as jrunner
import mpi_bicgstab_tpu.cli as jcli
import mpi_bicgstab_tpu.models.problem as jprob
import mpi_bicgstab_tpu.ops.sparse as jsparse
import mpi_bicgstab_tpu.utils.checkpoint as jckpt
import mpi_bicgstab_tpu.utils.config as jcfg
import mpi_bicgstab_tpu_torch.api as tapi
from mpi_bicgstab_tpu_torch import cli
from mpi_bicgstab_tpu_torch.benchmarks import runner
from mpi_bicgstab_tpu_torch.models.generators import banded_random
from mpi_bicgstab_tpu_torch.models.problem import build_problem
from mpi_bicgstab_tpu_torch.ops.precision import df_from_f64
from mpi_bicgstab_tpu_torch.utils import checkpoint as ckpt
from mpi_bicgstab_tpu_torch.utils.config import SolverConfig

torch.set_num_threads(1)
SOLVE = ["solve", "--matrix", "banded:1024", "--tol", "1e-10"]
SHIFTED = ["solve-shifted", "--matrix", "banded:1024", "--sigma-len", "4",
           "--seed", "1", "--tol", "1e-10"]


def _port(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli.main([*argv, "--device", "cpu"])
    return code, out.getvalue()


def _jax(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = jcli.main([*argv, "--platform", "cpu"])
    return code, out.getvalue()


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX CLI's `solve --json --dump-history` (.npy and .csv), run
    once for the tests below."""
    d = tmp_path_factory.mktemp("jax")
    out = {}
    for ext in ("npy", "csv"):
        code, text = _jax([*SOLVE, "--json", "--dump-history",
                           str(d / f"h.{ext}")])
        assert code == 0
        out["solve"] = _last_json(text)
        out[ext] = (np.loadtxt(d / "h.csv", delimiter=",", skiprows=1)[:, 1]
                    if ext == "csv" else np.load(d / "h.npy"))
    return out


@pytest.mark.parametrize("argv", [SOLVE, SHIFTED], ids=["solve", "shifted"])
def test_json_keys_equal_jax(jax_runs, argv):
    code, out = _port([*argv, "--json"])
    got = _last_json(out)
    if argv is SOLVE:
        want = jax_runs["solve"]
    else:
        jcode, jout = _jax([*SHIFTED, "--json"])
        assert jcode == 0
        want = _last_json(jout)
    assert code == 0
    assert list(got) == list(want)
    assert abs(got["total_iter"] - want["total_iter"]) <= 2
    if argv is SOLVE:
        assert tuple(got) == cli.SOLVE_JSON_KEYS


@pytest.mark.parametrize("repeat", [1, 3])
@pytest.mark.parametrize("argv,name", [(SOLVE, "solve"),
                                       (SHIFTED, "solve_shifted")])
def test_repeat_runs_once_untimed_then_n_times(monkeypatch, argv, name,
                                               repeat):
    calls = []
    real = getattr(tapi, name)
    monkeypatch.setattr(tapi, name,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    code, out = _port([*argv, "--repeat", str(repeat), "--json"])
    assert code == 0 and len(calls) == repeat + 1
    assert _last_json(out)["total_time_s"] > 0


@pytest.mark.parametrize("ext", ["npy", "csv"])
def test_dump_history_equals_history_and_jax(jax_runs, tmp_path, ext):
    path = str(tmp_path / f"h.{ext}")
    report, res = cli.run_solve(cli.build_parser().parse_args(
        [*SOLVE, "--dump-history", path, "--device", "cpu"]))
    if ext == "csv":
        table = np.loadtxt(path, delimiter=",", skiprows=1)
        assert open(path).readline().strip() == "iter,relres"
        assert np.array_equal(table[:, 0], np.arange(1, len(table) + 1))
        hist = table[:, 1]
    else:
        hist = np.load(path)
    n = report["total_iter"]
    assert hist.shape == (n,)
    np.testing.assert_array_equal(hist, res.history[:n].numpy())
    want = jax_runs[ext]
    m = min(len(want), n)
    assert abs(len(want) - n) <= 2
    np.testing.assert_allclose(hist[:m], want[:m], rtol=1e-6)


def test_shifted_dump_history(tmp_path):
    path = str(tmp_path / "h.npy")
    rows, res = cli.run_solve_shifted(cli.build_parser().parse_args(
        [*SHIFTED, "--dump-history", path, "--device", "cpu"]))
    hist = np.load(path)
    assert hist.shape == (rows[0]["total_iter"],)
    np.testing.assert_array_equal(hist, res.history[:len(hist)].numpy())


def test_verbose_every_prints_the_curve(tmp_path):
    path = str(tmp_path / "h.npy")
    code, out = _port([*SOLVE, "--verbose-every", "4", "--dump-history",
                       path])
    hist = np.load(path)
    lines = [ln for ln in out.splitlines() if ln.startswith("iter ")]
    labels = [int(ln.split()[1].rstrip(":")) for ln in lines]
    # printed by the untimed run and again by the timed one
    each = list(range(4, len(hist) + 1, 4))
    assert code == 0 and each and labels == each * 2
    vals = [float(ln.split()[-1]) for ln in lines[: len(each)]]
    np.testing.assert_allclose(vals, hist[3::4][: len(vals)], rtol=1e-5)


# --- the iterate checkpoint (JAX tests/test_checkpoint.py:34-110) ----------

def _ck_setup():
    csr = banded_random(1024, [1, -1, 9, -9], seed=4, diag_boost=0.1)
    prob = build_problem(csr, dtype=torch.float64, device="cpu")
    cfg = SolverConfig(tol=1e-11, max_iter=500)

    def run(x0_host, budget, tol_seg=None):
        x0 = None if x0_host is None else torch.as_tensor(x0_host)
        c = cfg.replace(max_iter=budget)
        if tol_seg is not None:
            c = c.replace(tol=tol_seg)
        return tapi.solve(prob.A, prob.b, x0=x0, method="bicgstab", cfg=c)

    jp = jprob.build_problem(jsparse.CSRMatrix(csr.ptr, csr.col, csr.val,
                                               csr.shape))
    jc = jcfg.SolverConfig(tol=1e-11, max_iter=500)

    def jrun(x0_host, budget, tol_seg=None):
        import jax.numpy as jnp
        x0 = None if x0_host is None else jnp.asarray(x0_host)
        c = jc.replace(max_iter=budget)
        if tol_seg is not None:
            c = c.replace(tol=tol_seg)
        return japi.solve(jp.A, jp.b, x0=x0, method="bicgstab", cfg=c)

    return csr, prob, run, jrun


def test_segmented_solve_matches_jax(tmp_path):
    csr, prob, run, jrun = _ck_setup()
    need = run(None, 500).n_iter
    res, done, cum = ckpt.solve_with_checkpoints(
        run, str(tmp_path / "t.npz"), segment_iters=15, max_iter=500,
        meta={"n": prob.n}, tol=1e-11)
    jres, jdone, jcum = jckpt.solve_with_checkpoints(
        jrun, str(tmp_path / "j.npz"), segment_iters=15, max_iter=500,
        meta={"n": prob.n}, tol=1e-11)
    # restarts rebuild the Krylov space: some overhead allowed, not 3x
    assert bool(res.converged) and cum <= 1e-11 and done <= 3 * need
    assert abs(done - jdone) <= 2
    np.testing.assert_allclose(cum, jcum, rtol=1e-6)
    assert np.abs(res.x.numpy()[: csr.nrows] - 1).max() < 1e-7
    assert ckpt.load_checkpoint(str(tmp_path / "t.npz"),
                                expect={"n": prob.n})[1] == done


def test_resume_after_interruption_and_across_packages(tmp_path):
    csr, prob, run, jrun = _ck_setup()
    finished = {}
    for writer, path in ((run, tmp_path / "t.npz"), (jrun, tmp_path /
                                                     "j.npz")):
        # "interrupted": one 4-iteration segment only (the JAX file too)
        r1, d1, _ = (ckpt if writer is run else jckpt).solve_with_checkpoints(
            writer, str(path), segment_iters=4, max_iter=4,
            meta={"n": prob.n}, tol=1e-11)
        assert not bool(r1.converged) and d1 == 4
        # the port resumes it and finishes
        r2, d2, c2 = ckpt.solve_with_checkpoints(
            run, str(path), segment_iters=500, max_iter=500,
            meta={"n": prob.n}, tol=1e-11)
        assert c2 <= 1e-11 and bool(r2.converged) and d2 > 4
        assert np.abs(r2.x.numpy()[: csr.nrows] - 1).max() < 1e-7
        finished[path] = (d2, c2)
    # a run already complete: no segment runs
    for path, (d2, c2) in finished.items():
        r3, d3, c3 = ckpt.solve_with_checkpoints(
            run, str(path), segment_iters=500, max_iter=500,
            meta={"n": prob.n}, tol=1e-11)
        assert r3 is None and d3 == d2 and c3 == c2


def test_checkpoint_metadata_guard(tmp_path):
    path = str(tmp_path / "ck.npz")
    ckpt.save_checkpoint(path, torch.zeros(8), 3, {"n": 8})
    assert ckpt.load_checkpoint(path, expect={"n": 8})[1] == 3
    assert jckpt.load_checkpoint(path, expect={"n": 8})[1] == 3
    with pytest.raises(ValueError, match="refusing to resume"):
        ckpt.load_checkpoint(path, expect={"n": 16})
    ckpt._atomic_savez(path, x=np.zeros(2), header=json.dumps({"format": 9}))
    with pytest.raises(ValueError, match="unknown checkpoint format"):
        ckpt.load_checkpoint(path)
    with pytest.raises(ValueError, match="segment_iters"):
        ckpt.solve_with_checkpoints(None, path, 0, 10, {}, 1e-8)


def test_df_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "ck.npz")
    v = np.linspace(0, 1, 7) + 1e-12
    ckpt.save_checkpoint(path, df_from_f64(v, "cpu"), 1, {"n": 7})
    x, done, header = ckpt.load_checkpoint(path)
    assert header["kind"] == "df" and x.dtype == np.float64
    np.testing.assert_allclose(x, v, rtol=0, atol=1e-15)
    assert np.array_equal(x, jckpt.load_checkpoint(path)[0])


@pytest.mark.parametrize("dtype", ["float64", "df32"])
def test_cli_checkpoint_segments_and_resumes(tmp_path, dtype):
    """`solve --checkpoint` in segments of 5 iterations: converged in a
    few more iterations than the solve without it (restarts rebuild the
    Krylov space), final_relres the cumulative residual; run again on
    the finished file it prints the JAX CLI's short report."""
    path = str(tmp_path / "ck.npz")
    base = [*SOLVE, "--dtype", dtype, "--json"]
    ref = _last_json(_port(base)[1])
    code, out = _port([*base, "--checkpoint", path, "--checkpoint-every",
                       "5"])
    got = _last_json(out)
    assert code == 0 and got["converged"] and got["final_relres"] <= 1e-10
    assert ref["total_iter"] <= got["total_iter"] <= 3 * ref["total_iter"]
    header = ckpt.load_checkpoint(path)[2]
    assert header["kind"] == ("df" if dtype == "df32" else "arr")
    assert header["n_iter_done"] == got["total_iter"]
    code, out = _port([*base, "--checkpoint", path])
    again = _last_json(out)
    assert code == 0 and again["note"] == "run already complete in " \
        "checkpoint" and again["total_iter"] == got["total_iter"]
    with pytest.raises(ValueError, match="refusing to resume"):
        _port([*base, "--checkpoint", path, "--scale", "jacobi"])


@pytest.mark.parametrize("extra,match", [
    (["--checkpoint", "C", "--repeat", "2"], "--repeat cannot be combined"),
    (["--checkpoint", "C", "--dump-history", "h.npy"],
     "--dump-history under --checkpoint"),
    (["--checkpoint", "C", "--x0", "X"], "--x0 cannot be combined"),
    (["--checkpoint", "C", "--precond", "cheby:4"],
     "--precond cannot be combined with --x0/--checkpoint"),
    (["--rhs-batch", "B", "--dump-history", "h.npy"],
     "--rhs-batch cannot be combined with --rhs or --dump-history"),
    (["--rhs-batch", "B", "--repeat", "2"],
     "--rhs-batch cannot be combined with --checkpoint/--x0/--repeat"),
    (["--repeat", "0"], "--repeat must be >= 1"),
])
def test_refusals_match_jax(tmp_path, extra, match):
    x = tmp_path / "x.npy"
    np.save(x, np.zeros(1024))
    np.save(tmp_path / "B.npy", np.ones((2, 1024)))
    subst = {"C": str(tmp_path / "c.npz"), "X": str(x),
             "B": str(tmp_path / "B.npy"), "h.npy": str(tmp_path / "h.npy")}
    argv = [*SOLVE, *(subst.get(a, a) for a in extra)]
    with pytest.raises(SystemExit, match=match):
        _port(argv)
    if extra != ["--repeat", "0"]:        # JAX runs zero timed solves
        with pytest.raises(SystemExit) as ex:
            _jax(argv)
        assert ex.value.code not in (None, 0)


# --- info, convert, selftest ------------------------------------------------

def test_info_on_the_cpu_reports_the_twins():
    code, out = _port(["info"])
    info = json.loads(out)
    assert code == 0 and info["device"] == "cpu"
    assert "twins" in info["kernels"]
    assert info["fused_kernels"]["bicgstab"] == ["f32", "df32"]
    assert info["fused_kernels"]["bicgstab_l2"] == []
    assert set(info["layouts"]) == {"dia", "hybrid", "ell", "window_ell",
                                    "butterfly"}
    assert {"process_count", "device_count", "devices", "fused_kernels",
            "layouts", "preconditioners"} <= set(info)


def test_convert_writes_the_jax_container(tmp_path):
    dst = str(tmp_path / "a.npz")
    code = cli.main(["convert", "banded:2000", dst])
    got = jsparse.load_csr_npz(dst)
    want, _ = cli._load_matrix("banded:2000")
    assert code == 0 and got.shape == want.shape
    assert np.array_equal(got.col, want.col)
    assert np.array_equal(got.val, want.val)
    report, _ = cli.run_solve(cli.build_parser().parse_args(
        ["solve", "--matrix", dst, "--device", "cpu"]))
    assert report["converged"] and report["n"] == 2000


@pytest.mark.parametrize("name", list(cli.SELFTEST))
def test_selftest_check_passes_on_the_cpu(name):
    ok, detail, seconds = cli.run_selftest_check(name, "float32", "cpu")
    assert ok, detail


def test_selftest_exits_2_on_a_failure(monkeypatch, capsys):
    monkeypatch.setattr(cli, "SELFTEST", {
        "good": lambda dt, tol, dev: (True, "fine"),
        "bad": lambda dt, tol, dev: (False, "broken"),
        "raises": lambda dt, tol, dev: 1 / 0})
    assert cli.main(["selftest", "--device", "cpu"]) == 2
    out = capsys.readouterr().out
    assert "PASS good" in out and "FAIL bad" in out
    assert "ZeroDivisionError" in out and "1/3 passed" in out


# --- bench ------------------------------------------------------------------

BENCH = ["bench", "--matrix", "transport-like:2000", "--what",
         "spmv,iter,shifted,cheby,batched", "--sigma-len", "8",
         "--iters", "12"]


def test_run_bench_has_the_jax_keys(monkeypatch, capsys):
    """Both benches with their timers stubbed (a constant slope): the
    port's line has every key of the JAX package's, and besides them only
    the card's name and power limit and the chain kernel's time where
    the port has a chain kernel for the operator."""
    monkeypatch.setattr(jrunner, "_slope_time", lambda *a, **k: 1e-3)
    assert jrunner.run_bench(jcli.build_parser().parse_args(
        [*BENCH, "--platform", "cpu"])) == 0
    want = _last_json(capsys.readouterr().out)
    monkeypatch.setattr(runner, "_require_cuda", lambda: None)
    monkeypatch.setattr(runner, "_slope_time", lambda *a, **k: 1e-3)
    assert runner.run_bench(cli.build_parser().parse_args(BENCH),
                            device="cpu") == 0
    got = _last_json(capsys.readouterr().out)
    assert set(want) <= set(got)
    assert set(got) - set(want) <= {"device_name", "power_limit",
                                    "cheby_fused_apply_s",
                                    "cheby_fused_speedup"}
    for k in ("matrix", "n", "nnz", "dtype", "devices", "spmv_layout",
              "iter_method", "sigma_len", "cheby_degree", "batched8_method"):
        assert got[k] == want[k], k
    assert got["backend"] == "cpu" and got["time_per_iter_s"] == 1e-3
    assert got["vs_baseline"] == got["spmv_nnz_per_s"] / 4.0e9
    assert got["batched8_per_rhs_speedup"] == 8.0


@pytest.mark.parametrize("what", ["overlap", "scaling"])
def test_bench_distributed_sections_name_slice_8(what):
    """The sections of the distributed layer's slice 8b run: the bench
    spawns its rank (which prints the line) and exits 0."""
    args = cli.build_parser().parse_args(
        ["bench", "--what", f"spmv,{what}", "--matrix", "banded:512",
         "--iters", "6", "--device", "cpu"])
    assert runner.run_bench(args) == 0


def test_bench_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main(["bench", "--matrix", "banded:1024"])
    args = SimpleNamespace(what="spmv")
    with pytest.raises(RuntimeError, match="CUDA device"):
        runner.run_bench(args)
