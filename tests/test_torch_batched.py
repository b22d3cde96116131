"""Port vs JAX package: batched right-hand sides (api.solve_batched and
`solve --rhs-batch`, on the CPU).

On the CPU the JAX package solves a batch with jax.vmap over its unfused
solver (its batched Pallas kernels engage only on a TPU, or when forced),
so each JAX lane is the lane solved alone. The port routes float32
bicgstab on a DIA matrix with k <= 8 lanes through its fused batched
driver (the kernels' plain twins on the CPU) and everything else lane by
lane through its unfused solvers. Per lane: n_iter within +-2 of JAX's
(+-6 over restart segments, +-2 per segment), the same `converged`, the
history within rtol 1e-6 over the common prefix in float64, the solutions
within 1e-3 in float32 and 1e-10 in float64 and df32.
"""
import contextlib
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
import mpi_bicgstab_tpu.ops.precision as jp
import mpi_bicgstab_tpu.utils.config as jcfg
import mpi_bicgstab_tpu_torch.api as tapi
import mpi_bicgstab_tpu_torch.models.generators as tgen
import mpi_bicgstab_tpu_torch.models.problem as tprob
import mpi_bicgstab_tpu_torch.ops.precision as tp
from mpi_bicgstab_tpu_torch import cli
from mpi_bicgstab_tpu_torch.solvers import batched_fused
from mpi_bicgstab_tpu_torch.utils.config import SolverConfig

torch.set_num_threads(1)


def _f32_fixture():
    """banded_random(8192) and three right-hand sides that stop at
    different iterations: a random solution's image, A 1, and the image
    of a near-dominant eigenvector (converges in 1-2 steps and freezes
    while the others run)."""
    args = (8192, [1, -1, 12, -12])
    csr = tgen.banded_random(*args, seed=7)
    rng = np.random.default_rng(1)
    v = rng.standard_normal(csr.nrows)
    for _ in range(40):
        v = csr.matvec(v)
        v /= np.linalg.norm(v)
    B = np.stack([csr.matvec(rng.standard_normal(csr.nrows)),
                  csr.matvec(np.ones(csr.nrows)), csr.matvec(v)])
    return csr, jgen.banded_random(*args, seed=7), B.astype(np.float32)


def _f32_port(B, csr, solve):
    pt = tprob.build_problem(csr, dtype="float32", device="cpu")
    return solve(pt.A, torch.from_numpy(B))


def _f32_jax(B, csr_j, max_iter):
    pj = jprob.build_problem(csr_j, dtype=jnp.float32, multiple=8192)
    return japi.solve_batched(pj.A, B, method="bicgstab",
                              cfg=jcfg.SolverConfig(
                                  tol=1e-5, max_iter=max_iter,
                                  dtype=jnp.float32, restarts=0))


def _same_lanes(rt, rj, x_atol, n_atol=2):
    ni_t, ni_j = rt.n_iter.numpy(), np.asarray(rj.n_iter)
    assert np.abs(ni_t - ni_j).max() <= n_atol, (ni_t, ni_j)
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    x_j = jp.df_to_f64(rj.x) if jp.is_df(rj.x) else np.asarray(rj.x)
    x_t = tp.df_to_f64(rt.x) if tp.is_df(rt.x) else rt.x.double().numpy()
    np.testing.assert_allclose(x_t, x_j[:, :x_t.shape[1]], rtol=0,
                               atol=x_atol)


def test_f32_fused_route_matches_jax(monkeypatch):
    csr, csr_j, B = _f32_fixture()
    called = []
    real = batched_fused.bicgstab_batched_fully_fused
    monkeypatch.setattr(batched_fused, "bicgstab_batched_fully_fused",
                        lambda *a: called.append(1) or real(*a))
    cfg = SolverConfig(tol=1e-5, max_iter=80, dtype="float32", restarts=0)
    rt = _f32_port(B, csr, lambda A, Bt: tapi.solve_batched(A, Bt, cfg=cfg))
    assert called == [1]                 # the fused batched driver ran
    rj = _f32_jax(B, csr_j, 80)
    assert rt.converged.all()
    ni = rt.n_iter.tolist()
    assert ni[2] < ni[1] and len(set(ni)) > 1, ni    # lanes stop apart
    _same_lanes(rt, rj, 1e-3)
    h = rt.history.numpy()
    for j, k in enumerate(ni):           # a frozen lane's slots are NaN
        assert np.isfinite(h[j, :k]).all() and np.isnan(h[j, k:]).all()


@pytest.mark.parametrize("k", [3, 8])
def test_fused_route_lane_equals_its_solve_alone(k):
    """vmap's contract on the fused batched driver: each of k lanes (the
    fixture's three, repeated to format_ok's limit of 8) stops at the
    iteration, with the history and the solution bit for bit, that the
    same lane takes solved alone (k = 1, the same driver)."""
    csr, _, B = _f32_fixture()
    cfg = SolverConfig(tol=1e-5, max_iter=80, dtype="float32", restarts=0)
    Bk = B[np.arange(k) % 3]
    batch = _f32_port(Bk, csr, lambda A, Bt: tapi.solve_batched(A, Bt,
                                                                cfg=cfg))
    alone = [_f32_port(B[j:j + 1], csr, lambda A, Bt: tapi.solve_batched(
        A, Bt, cfg=cfg)) for j in range(3)]
    assert len(set(batch.n_iter.tolist())) > 1
    for j in range(k):
        one = alone[j % 3]
        it = int(one.n_iter[0])
        assert int(batch.n_iter[j]) == it
        assert bool(batch.converged[j]) == bool(one.converged[0])
        assert torch.equal(batch.x[j], one.x[0])
        assert torch.equal(batch.history[j, :it], one.history[0, :it])


def test_tol0_runs_exactly_max_iter_on_every_lane():
    csr, _, B = _f32_fixture()
    res = _f32_port(B, csr, lambda A, Bt: tapi.solve_batched(
        A, Bt, cfg=SolverConfig(tol=0.0, max_iter=30, dtype="float32")))
    assert res.n_iter.tolist() == [30, 30, 30]
    assert res.history.shape == (3, 30)


def test_route_follows_format_ok(monkeypatch):
    """float32 bicgstab on a square DiaMatrix with 1..8 lanes takes the
    fused batched driver; 9 lanes, float64, another layout or another
    method solve lane by lane, each lane as if solved alone."""
    from mpi_bicgstab_tpu_torch.ops import cuda_batched_spmv as cbs
    from mpi_bicgstab_tpu_torch.ops.dia import DiaMatrix
    csr = tgen.banded_random(1000, [1, -1, 30, -30], seed=3)
    p32 = tprob.build_problem(csr, dtype="float32", device="cpu")
    p64 = tprob.build_problem(csr, device="cpu")
    ell = tprob.build_problem(csr, dtype="float32", format="ell",
                              device="cpu")
    assert cbs.format_ok(p32.A, torch.float32, 8)
    assert not cbs.format_ok(p32.A, torch.float32, 9)
    assert not cbs.format_ok(p32.A, torch.float32, 0)
    assert not cbs.format_ok(p64.A, torch.float64, 2)
    assert not cbs.format_ok(ell.A, torch.float32, 2)
    wide = DiaMatrix(torch.zeros(65, 1000), tuple(range(65)), 1000, 1000)
    assert not cbs.format_ok(wide, torch.float32, 2)
    monkeypatch.setattr(batched_fused, "bicgstab_batched_fully_fused",
                        lambda *a: pytest.fail("took the fused driver"))
    rng = np.random.default_rng(0)
    B = torch.as_tensor(rng.standard_normal((9, 1000)), dtype=torch.float32)
    cfg = SolverConfig(tol=1e-5, max_iter=200, dtype="float32")
    for A, Bk, method in ((p32.A, B, "bicgstab"), (ell.A, B[:2], "bicgstab"),
                          (p32.A, B[:2], "ca_bicgstab")):
        res = tapi.solve_batched(A, Bk, method=method, cfg=cfg)
        assert res.converged.all() and res.x.shape == Bk.shape
        for j in (0, len(Bk) - 1):
            alone = tapi.solve(A, Bk[j], method=method, cfg=cfg)
            assert abs(alone.n_iter - int(res.n_iter[j])) <= 2
            torch.testing.assert_close(res.x[j], alone.x, rtol=0,
                                       atol=1e-3)


def _pair(n=3000, offsets=(1, -1, 50, -50), seed=5, k=2):
    rng = np.random.default_rng(seed)
    csr_t = tgen.banded_random(n, list(offsets), seed=seed)
    csr_j = jgen.banded_random(n, list(offsets), seed=seed)
    B = np.stack([csr_t.matvec(rng.standard_normal(n)) for _ in range(k)])
    return csr_t, csr_j, B


@pytest.mark.parametrize("method,dtype", [("ca_bicgstab", "float64"),
                                          ("bicgstab", "df32"),
                                          ("bicgstab_l2", "float64")])
def test_per_lane_route_matches_jax(method, dtype):
    csr_t, csr_j, B = _pair()
    tol = 1e-10
    pt = tprob.build_problem(csr_t, dtype=dtype, multiple=1, device="cpu")
    pj = jprob.build_problem(csr_j, dtype=dtype if dtype == "df32"
                             else jnp.float64, multiple=1)
    if dtype == "df32":
        Bt, Bj = tp.df_from_f64(B), jp.df_from_f64(B)
    else:
        Bt, Bj = torch.from_numpy(B), B
    rt = tapi.solve_batched(pt.A, Bt, method=method, cfg=SolverConfig(
        tol=tol, max_iter=300, dtype=dtype))
    rj = japi.solve_batched(pj.A, Bj, method=method, cfg=jcfg.SolverConfig(
        tol=tol, max_iter=300,
        dtype=jnp.float32 if dtype == "df32" else jnp.float64))
    assert rt.converged.all()
    _same_lanes(rt, rj, 1e-10)
    if dtype == "float64":
        hj = np.asarray(rj.history)
        for j, k in enumerate(np.minimum(rt.n_iter.numpy(),
                                         np.asarray(rj.n_iter))):
            np.testing.assert_allclose(rt.history[j, :k].numpy(),
                                       hj[j, :k], rtol=1e-6)


def test_lane_restarts_match_jax():
    """float32 asked for more than float32 attains (tol 1e-9): in one pass
    both lanes' recurrences hit tol while their true residuals miss the
    gate; with restarts each lane re-enters the single-RHS solver on its
    own (the port's fused classic driver) and comes back converged, its
    n_iter the total over its segments, as in the JAX package."""
    args = (4000, [1, -1, 60, -60])
    csr_t = tgen.banded_random(*args, seed=9)
    csr_j = jgen.banded_random(*args, seed=9)
    rng = np.random.default_rng(0)
    B = np.stack([csr_t.matvec(np.ones(4000)),
                  csr_t.matvec(rng.standard_normal(4000))])
    pt = tprob.build_problem(csr_t, dtype="float32", multiple=1,
                             device="cpu")
    pj = jprob.build_problem(csr_j, dtype=jnp.float32, multiple=1)
    out = {}
    for restarts in (0, 2):
        out[restarts] = (
            tapi.solve_batched(pt.A, torch.as_tensor(B, dtype=torch.float32),
                               cfg=SolverConfig(tol=1e-9, max_iter=300,
                                                dtype="float32",
                                                restarts=restarts)),
            japi.solve_batched(pj.A, B.astype(np.float32),
                               cfg=jcfg.SolverConfig(tol=1e-9, max_iter=300,
                                                     dtype=jnp.float32,
                                                     restarts=restarts)))
    rt0, rj0 = out[0]
    assert not rt0.converged.any() and not np.asarray(rj0.converged).any()
    rt, rj = out[2]
    assert rt.converged.all() and (rt.n_iter > rt0.n_iter).all()
    _same_lanes(rt, rj, 1e-3, n_atol=6)
    h = rt.history.numpy()
    for j, k in enumerate(rt.n_iter.tolist()):   # one curve over segments
        assert np.isfinite(h[j, :k]).all() and np.isnan(h[j, k:]).all()


def test_solve_batched_refusals():
    pt = tprob.build_problem(tgen.poisson2d(8), device="cpu")
    B = torch.stack([pt.b, pt.b])
    # slices 7 and 3c are ported: a preconditioner without bounds is
    # refused, df32 pipelined BiCGStab solves lane by lane
    from mpi_bicgstab_tpu_torch.ops.cheby import ChebyPrecond
    with pytest.raises(ValueError, match="bounds"):
        tapi.solve_batched(pt.A, B, precond=ChebyPrecond(4))
    pdf = tprob.build_problem(tgen.poisson2d(8), dtype="df32", device="cpu")
    Bdf = tp.DF(torch.stack([pdf.b.hi] * 2), torch.stack([pdf.b.lo] * 2))
    res = tapi.solve_batched(pdf.A, Bdf, method="pipe_bicgstab",
                             cfg=SolverConfig(tol=1e-10, dtype="df32"))
    assert res.converged.all() and tp.is_df(res.x)
    assert np.abs(tp.df_to_f64(res.x) - 1.0).max() < 1e-8
    with pytest.raises(ValueError, match="k, n"):
        tapi.solve_batched(pt.A, pt.b)
    with pytest.raises(ValueError, match="unknown method"):
        tapi.solve_batched(pt.A, B, method="nope")


# --- the CLI ------------------------------------------------------------------

def _rhs_file(tmp_path, n=4096, k=3):
    """B.npy for banded:N: A 1, A x for a seeded x, and a random vector."""
    csr, _ = cli._load_matrix(f"banded:{n}")
    rng = np.random.default_rng(0)
    B = np.stack([csr.matvec(np.ones(n)), csr.matvec(rng.standard_normal(n)),
                  rng.standard_normal(n)][:k])
    path = tmp_path / "B.npy"
    np.save(path, B)
    return str(path)


BATCH = ["solve", "--matrix", "banded:4096", "--dtype", "float32",
         "--tol", "1e-5"]


def test_cli_rhs_batch_matches_jax(tmp_path):
    bfile = _rhs_file(tmp_path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jcode = jcli.main([*BATCH, "--rhs-batch", bfile, "--platform", "cpu",
                           "--json"])
    want = json.loads(out.getvalue().strip().splitlines()[-1])
    sol = tmp_path / "X.npy"
    args = cli.build_parser().parse_args(
        [*BATCH, "--rhs-batch", bfile, "--device", "cpu",
         "--write-solution", str(sol)])
    got, res = cli.run_solve(args)
    assert set(got) == set(want)
    assert got["batch"] == want["batch"] == 3
    assert got["converged"] == want["converged"] == [True] * 3
    assert jcode == 0
    assert np.abs(np.subtract(got["n_iter"], want["n_iter"])).max() <= 2
    for key in ("method", "matrix", "n"):
        assert got[key] == want[key], key
    X = np.load(sol)
    assert X.shape == (3, 4096) and X.dtype == np.float64
    assert np.abs(X[0] - 1.0).max() < 1e-3


def test_cli_rhs_batch_prints_and_exits(tmp_path):
    bfile = _rhs_file(tmp_path, n=512, k=2)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli.main(["solve", "--matrix", "banded:512", "--rhs-batch",
                         bfile, "--device", "cpu", "--tol", "1e-10"])
    lines = {k.strip(): v.strip() for k, v in (
        line.split(":", 1) for line in out.getvalue().splitlines())}
    assert code == 0 and lines["converged"] == "[True, True]"
    assert lines["batch"] == "2" and lines["n"] == "512"
    with contextlib.redirect_stdout(io.StringIO()):
        code = cli.main(["solve", "--matrix", "banded:512", "--rhs-batch",
                         bfile, "--device", "cpu", "--max-iter", "2",
                         "--restarts", "0"])
    assert code == 2


def test_cli_rhs_batch_refusals(tmp_path):
    bfile = _rhs_file(tmp_path, n=512, k=2)
    np.save(tmp_path / "b.npy", np.ones(512))
    both = ["solve", "--matrix", "banded:512", "--rhs-batch", bfile,
            "--rhs", str(tmp_path / "b.npy")]
    with pytest.raises(SystemExit) as jex:
        jcli.main([*both, "--platform", "cpu"])
    with pytest.raises(SystemExit) as tex:
        cli.main([*both, "--device", "cpu"])
    assert str(tex.value) == str(jex.value)
    assert "--rhs-batch cannot be combined with --rhs" in str(tex.value)
    np.save(tmp_path / "bad.npy", np.ones((2, 100)))
    with pytest.raises(SystemExit, match=r"expected \[k, 512\]"):
        cli.main(["solve", "--matrix", "banded:512", "--rhs-batch",
                  str(tmp_path / "bad.npy"), "--device", "cpu"])
    if not torch.cuda.is_available():    # the card is the default device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["solve", "--matrix", "banded:512", "--rhs-batch",
                      bfile])


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("phase", ["float32", "float64", "df32"])
def test_chip_smoke_batched_phases_on_cpu(phase, tmp_path):
    """chip_smoke's batched phases at n = 8192 on the CPU: every lane
    converged within its checks, each f32 lane's n_iter within 1 of its
    single-RHS solve, and no kernel counted (plain twins only)."""
    smoke = _chip_smoke()
    if phase == "float32":
        counts = smoke.run_batched_path(8192, "cpu", workdir=tmp_path)
    else:
        counts = smoke.run_batched_lanes(8192, phase, "cpu",
                                         workdir=tmp_path)
    assert set(smoke.BATCHED) <= set(counts)
    assert set(counts.values()) == {0}
