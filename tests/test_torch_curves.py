"""Port vs JAX package: the residual-curve recorder
(scripts/record_curves_torch.py against scripts/record_curves.py).

The method loop writes one `iter,relres` CSV per method and prints one
JSON row per method (the JAX script's keys, plus eager_ms_per_iter and
the card's name and power limit). Per method, on transport_hard(4096) in
df32 at tol 1e-12 with JAX's SolverConfig(krr=400, nrr=8): the curve's
first 20 points equal JAX's history within 1e-6 relative, converged is
JAX's, a converged method's true residual is at most 100 tol, and its
iteration count lies within 10% of JAX's. The 10% and the 20 points, not
+-2 iterations: on this hard, non-normal matrix the two packages' curves
part at about iteration 21-24 in df32 (and 24-26 in float64: the SpMV's
summation order is enough), so a 300-600 iteration trajectory lands
apart (df32 here: classic 315 / 318, CA 358 / 341, pipelined-RR 594 /
575); plain pipelined stalls in JAX and breaks down in the port, and
converges in neither.
"""
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_bicgstab_tpu.api import solve as j_solve
from mpi_bicgstab_tpu.models.generators import transport_hard as j_hard
from mpi_bicgstab_tpu.models.problem import build_problem as j_build
from mpi_bicgstab_tpu.utils.config import SolverConfig as JConfig
from mpi_bicgstab_tpu_torch.models.generators import transport_hard

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
N, TOL, MAX_ITER = 4096, 1e-12, 2000
KEYS = {"method", "iters", "final_relres", "true_relres", "converged",
        "wall_s", "curve", "eager_ms_per_iter", "device_name", "power_limit"}


def _recorder():
    spec = importlib.util.spec_from_file_location(
        "record_curves_torch", REPO / "scripts" / "record_curves_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _curve(path):
    with open(path) as f:
        assert f.readline().strip() == "iter,relres"
    return np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)


def test_method_loop_writes_curves_and_rows(tmp_path, capsys):
    rec = _recorder()
    rows = rec.record_methods(transport_hard(N), "df32", TOL, 60, "cpu",
                              str(tmp_path))
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert printed == rows
    assert [r["method"] for r in rows] == list(rec.METHODS)
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        f"torch_hard4k_df32_{m}.csv" for m in rec.METHODS)
    for r in rows:
        assert set(r) == KEYS
        assert r["device_name"] is None and r["power_limit"] is None
        c = _curve(tmp_path / r["curve"])
        assert c.shape == (r["iters"], 2)
        np.testing.assert_array_equal(c[:, 0], np.arange(1, r["iters"] + 1))
        assert np.isfinite(c[:, 1]).all()
        assert r["eager_ms_per_iter"] > 0


@pytest.fixture(scope="module")
def jax_problem():
    return j_build(j_hard(N), dtype="df32")


@pytest.mark.parametrize("method", ["bicgstab", "ca_bicgstab",
                                    "pipe_bicgstab", "pipe_bicgstab_rr"])
def test_curve_follows_jax(jax_problem, tmp_path, method):
    rec = _recorder()
    (row,) = rec.record_methods(transport_hard(N), "df32", TOL, MAX_ITER,
                                "cpu", str(tmp_path), methods=(method,))
    res = j_solve(jax_problem.A, jax_problem.b, method=method,
                  cfg=JConfig(tol=TOL, max_iter=MAX_ITER, dtype=jnp.float32,
                              krr=400, nrr=8))
    jax.block_until_ready(res.x)
    hist = np.asarray(res.history, np.float64)
    curve = _curve(tmp_path / row["curve"])[:, 1]
    np.testing.assert_allclose(curve[:20], hist[:20], rtol=1e-6)
    assert row["converged"] == bool(res.converged)
    if row["converged"]:
        assert row["true_relres"] <= 100 * TOL
        assert abs(row["iters"] - int(res.n_iter)) <= 0.1 * int(res.n_iter)


def test_chip_smoke_curves_phase_on_cpu(tmp_path):
    """chip_smoke's [curves] at n = 512 on the CPU: the loop under
    no_twin_on_card, each method's launches counted (none on the CPU),
    the gated methods converged with a true relres <= 1e-12. At tol 1e-10:
    at this size both packages' pipelined recurrences stall near 1e-12
    and end in NaN at tol 1e-14 (JAX after 350 iterations, the port after
    321), where the full-size curves go on converging."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    runs = smoke.run_curves(transport_hard(512), device="cpu", tol=1e-10,
                            out_dir=tmp_path)
    assert len(list(tmp_path.glob("torch_hard0k_df32_*.csv"))) == 4
    assert list(runs) == list(_recorder().METHODS)
    assert not any(v for c in runs.values() for v in c.values())
    assert smoke.tpu_record_iters("bicgstab") == 4724
