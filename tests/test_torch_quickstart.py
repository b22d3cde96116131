"""Port vs JAX package: the library tour (examples/quickstart_torch.py
against examples/quickstart.py).

Each section function runs on the CPU and is held to the JAX API call
that examples/quickstart.py makes with the same inputs: converged equal
and n_iter within 2 (the batched section lane by lane; the distributed
section on 2 gloo ranks against JAX's 2 virtual devices). Two sections
run long, erratic trajectories where a last-bit difference moves the
count (ROADMAP queue 3): the plain solve of the hard regime (~290
iterations; the Chebyshev-preconditioned one, 35, keeps the +-2 bar)
and BiCGStab(2) on the skew spectrum (~1100): there n_iter lies within
10% of JAX's, converged is equal, and the classic method fails in both.
The whole script runs once in a subprocess on the CPU with one rank
(chip_smoke.py's [quickstart]): exit 0 and every section's line, the
mesh section's hint included.
"""
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_bicgstab_tpu.api import solve as j_solve
from mpi_bicgstab_tpu.api import solve_batched as j_solve_batched
from mpi_bicgstab_tpu.api import solve_shifted as j_solve_shifted
from mpi_bicgstab_tpu.models import generators as jgen
from mpi_bicgstab_tpu.models.problem import build_problem as j_build
from mpi_bicgstab_tpu.ops.cheby import ChebyPrecond as JCheby
from mpi_bicgstab_tpu.ops.cheby import estimate_bounds as j_bounds
from mpi_bicgstab_tpu.parallel.driver import (solve_distributed as
                                              j_solve_distributed)
from mpi_bicgstab_tpu.parallel.partition import partition_csr as j_partition
from mpi_bicgstab_tpu.utils.config import ShiftedConfig as JShifted
from mpi_bicgstab_tpu.utils.config import SolverConfig as JConfig

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "examples" / "quickstart_torch.py"


@pytest.fixture(scope="module")
def qs():
    spec = importlib.util.spec_from_file_location("quickstart_torch", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _csr():
    return jgen.banded_random(4096, [1, -1, 16, -16], seed=0)


def _same(res, want, bar=2):
    assert bool(res.converged) == bool(want.converged)
    assert abs(int(res.n_iter) - int(want.n_iter)) <= bar


def test_classic_section(qs):
    line, res = qs.classic("cpu")
    p = j_build(_csr(), dtype=jnp.float64)
    _same(res, j_solve(p.A, p.b, method="pipe_bicgstab",
                       cfg=JConfig(tol=1e-10, max_iter=1000)))
    assert line.startswith(f"pipe_bicgstab: {res.n_iter} iters")


def test_shifted_section(qs):
    line, res = qs.shifted("cpu")
    p = j_build(_csr(), dtype=jnp.float64)
    want = j_solve_shifted(p.A, p.b, np.array([0.0, 0.01, 0.05, 0.2]),
                           seed=0, method="shifted_lopbicg_switching",
                           cfg=JShifted(tol=1e-10, max_iter=1000))
    assert abs(res.n_iter - int(want.n_iter)) <= 2
    assert bool(res.stop_flags.all()) == bool(np.asarray(
        want.stop_flags).all()) is True
    assert line.endswith("all converged: True")


def test_df32_section(qs):
    line, res = qs.df32("cpu")
    p = j_build(_csr(), dtype="df32")
    _same(res, j_solve(p.A, p.b, method="bicgstab",
                       cfg=JConfig(tol=1e-12, max_iter=1000,
                                   dtype=jnp.float32)))
    assert line.startswith("df32: relres")


def test_cheby_section(qs):
    line, (r_plain, r_prec) = qs.cheby("cpu")
    csr_h = jgen.transport_hard(4096)
    p = j_build(csr_h)
    lo, hi = j_bounds(csr_h)
    cfg = JConfig(tol=1e-10, max_iter=3000)
    w_plain = j_solve(p.A, p.b, cfg=cfg)
    w_prec = j_solve(p.A, p.b, cfg=cfg, precond=JCheby(degree=8, lo=lo,
                                                       hi=hi))
    _same(r_prec, w_prec)
    _same(r_plain, w_plain, bar=0.1 * int(w_plain.n_iter))
    assert line == (f"hard regime: {r_plain.n_iter} iters plain -> "
                    f"{r_prec.n_iter} with cheby:8")


def test_batched_section_lane_by_lane(qs):
    line, res = qs.batched("cpu")
    csr = _csr()
    p = j_build(csr, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    B = np.stack([csr.matvec(rng.standard_normal(csr.nrows))
                  for _ in range(4)])
    Bp = np.zeros((4, p.n))
    Bp[:, : csr.nrows] = B
    want = j_solve_batched(p.A, jnp.asarray(Bp),
                           cfg=JConfig(tol=1e-10, max_iter=1000))
    for got, w, c, wc in zip(res.n_iter.tolist(),
                             np.asarray(want.n_iter).tolist(),
                             res.converged.tolist(),
                             np.asarray(want.converged).tolist(),
                             strict=True):
        assert abs(got - w) <= 2 and c == wc
    assert line.endswith("all converged: True")


def test_bicgstab_l_section(qs):
    line, (r_classic, r_l2) = qs.bicgstab_l("cpu")
    p = j_build(jgen.skew_banded(1024))
    w_classic = j_solve(p.A, p.b, method="bicgstab",
                        cfg=JConfig(tol=1e-10, max_iter=2000, restarts=0))
    w_l2 = j_solve(p.A, p.b, method="bicgstab_l2",
                   cfg=JConfig(tol=1e-10, max_iter=2000, restarts=0))
    assert not bool(r_classic.converged) and not bool(w_classic.converged)
    _same(r_l2, w_l2, bar=0.1 * int(w_l2.n_iter))
    assert bool(r_l2.converged)
    assert "bicgstab_l2 converged=True" in line


def test_distributed_section_on_two_ranks(qs):
    line, res = qs.distributed("cpu", 2)
    csr = _csr()
    part = j_partition(csr, 2, dtype=np.float64)
    want = j_solve_distributed(part, csr.matvec(np.ones(csr.nrows)),
                               method="pipe_bicgstab",
                               cfg=JConfig(tol=1e-10, max_iter=1000))
    _same(res, want)
    assert line.startswith("distributed over 2 devices:")
    hint, none = qs.distributed("cpu", 1)
    assert none is None and "--ranks" in hint
    assert qs.sigma_grid("cpu", 4) == (None, None)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_whole_script_on_the_cpu(capsys):
    """chip_smoke's [quickstart] on the CPU: the script in a subprocess
    with --device cpu --ranks 1 exits 0 and prints every section's line,
    the mesh section's hint included."""
    _chip_smoke().run_quickstart("cpu")
    printed = capsys.readouterr().out.splitlines()
    lines = [ln[len("[quickstart] "):] for ln in printed
             if ln.startswith("[quickstart] ") and "seconds=" not in ln]
    starts = ("pipe_bicgstab: ", "shifted (4 shifts): ", "df32: relres ",
              "hard regime: ", "batched 4-RHS: ", "(1 device visible",
              "skew-dominant spectrum: ")
    assert len(lines) == len(starts)
    for ln, s in zip(lines, starts, strict=True):
        assert ln.startswith(s), ln
    assert re.search(r"bicgstab_l2 converged=True in \d+ iters", lines[-1])
