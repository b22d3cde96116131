"""Port vs JAX package: the driver hooks (mpi_bicgstab_tpu_torch/entry.py
against __graft_entry__.py).

entry(): the flagship step (seed-switching shifted LOP-BiCG, float32,
n = 512, 4 shifts, seed 3) gives JAX's x_set within 1e-4 relative and its
n_iter within 2. dryrun_multichip at 2 and 4 gloo ranks passes every
assert of JAX's dry run (the 4-rank run includes the 2 x 2 rows x sigma
grid); its shifted switching and pipelined parts take the n_iter of
JAX's solve_shifted_distributed / solve_distributed on the conftest's
virtual CPU devices at the same count, within 2. Without a card both
hooks raise, as parallel/launch.py's run and Pool do.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_bicgstab_tpu.parallel.driver import (solve_distributed as
                                              j_solve_distributed,
                                              solve_shifted_distributed as
                                              j_solve_shifted_distributed)
from mpi_bicgstab_tpu.parallel.mesh import make_row_mesh as j_row_mesh
from mpi_bicgstab_tpu.parallel.partition import partition_csr as j_partition
from mpi_bicgstab_tpu.utils.config import ShiftedConfig as JShifted
from mpi_bicgstab_tpu.utils.config import SolverConfig as JConfig
from mpi_bicgstab_tpu_torch import entry as tentry

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def _jax_entry():
    """__graft_entry__.py, loaded from the repository root."""
    spec = importlib.util.spec_from_file_location(
        "graft_entry_reference", REPO / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_matches_jax():
    fn, args = tentry.entry(device="cpu")
    b, sigma = args
    assert b.dtype == sigma.dtype == torch.float32 and b.device.type == "cpu"
    x_set, n_iter, relres = fn(*args)
    jfn, jargs = _jax_entry().entry()
    jx, jk, jr = jax.jit(jfn)(*jargs)
    assert tuple(x_set.shape) == tuple(jx.shape) == (4, 512)
    assert abs(n_iter - int(jk)) <= 2
    jx = np.asarray(jx, np.float64)
    assert np.abs(x_set.double().numpy() - jx).max() <= 1e-4 * np.abs(jx).max()
    assert float(relres) <= 1e-5 and float(jr) <= 1e-5


def test_hooks_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()
    with pytest.raises(ValueError, match="CUDA device"):
        tentry.dryrun_multichip(2)


def test_launch_defaults_to_the_card():
    """launch.run and launch.Pool run on the card unless asked for the
    CPU: with no device they raise on a machine without one, before any
    rank starts."""
    from mpi_bicgstab_tpu_torch.parallel import driver, launch
    if torch.cuda.device_count() >= 2:
        pytest.skip("two CUDA devices are present")
    with pytest.raises(ValueError, match="CUDA device"):
        launch.run(driver.spmv_global, 2, None, None)
    with pytest.raises(ValueError, match="CUDA device"):
        launch.Pool(2)


def _jax_parts(n):
    """JAX's shifted switching and pipelined dry-run solves on n virtual
    devices: (shifted n_iter, pipelined n_iter)."""
    csr, b, sigma = tentry._tiny_problem(16 * n, np.float32)
    part = j_partition(csr, n, dtype=np.float32)
    mesh = j_row_mesh(n)
    res = j_solve_shifted_distributed(
        part, b, np.asarray(sigma), seed=3,
        method="shifted_lopbicg_switching",
        cfg=JShifted(tol=1e-4, max_iter=8, dtype=jnp.float32), mesh=mesh)
    res2 = j_solve_distributed(
        part, b, method="pipe_bicgstab",
        cfg=JConfig(tol=1e-4, max_iter=8, dtype=jnp.float32), mesh=mesh)
    return int(res.n_iter), int(res2.n_iter)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_gloo_ranks(n):
    out = tentry.dryrun_multichip(n, device="cpu")
    want = {"shifted", "pipe", "df32", "cheby", "batched", "fused_classic",
            "fused_pipe", "fused_df32"} | ({"grid"} if n == 4 else set())
    assert set(out) == want
    assert out["df32"]["true_relres"] < 1e-8
    assert len(out["batched"]["n_iter"]) == 2
    for part in ("fused_classic", "fused_pipe", "fused_df32"):
        assert out[part]["n_iter"] == 4     # max_iter, as JAX's dry run
    j_shifted, j_pipe = _jax_parts(n)
    assert abs(out["shifted"]["n_iter"] - j_shifted) <= 2
    assert abs(out["pipe"]["n_iter"] - j_pipe) <= 2
    for part in want - {"batched"}:
        assert np.isfinite(out[part]["relres"]), part


def test_chip_smoke_entry_and_dryrun_phases_on_cpu():
    """chip_smoke's [entry] (the step on the CPU twice) and [dryrun]
    (dryrun_multichip(1) in place on a one-rank gloo group of this
    process) on the CPU: every assert passes, no launch is counted."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert not any(smoke.run_entry("cpu").values())
    smoke.init_world("cpu")
    try:
        assert not any(smoke.run_dryrun("cpu").values())
    finally:
        smoke.end_world()
