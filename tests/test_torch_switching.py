"""Port vs JAX package: the per-shift-stopping and seed-switching solvers
(solvers/switching.py) and the blocked shift updates
(solvers/switching_blocked.py).

Fixture: the JAX package's switching ladder of tests/test_switching.py
(banded_random(120), sigma [0, 0.05, 0.2, 1.0, 4.0], seed 4, b = (A +
sigma_seed I) ones), on which a seed at the top of the ladder converges
first and the solver switches, in both packages. Tolerances as in
test_torch_shifted.py: n_iter within +-2, final seed and stop flags
equal, shift_relres within rtol 1e-6 in float64 where n_iter is equal,
solutions within 1e-8, every shift's true residual at most 100 tol. The
blocked path is compared with the JAX package's blocked path at the same
depth (blocked and per-iteration results agree only to rounding).
"""
import contextlib
import io

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
from mpi_bicgstab_tpu_torch.ops import cuda_shift_update as csu
from mpi_bicgstab_tpu_torch.solvers.switching_blocked import resolve_block
from mpi_bicgstab_tpu_torch.utils.config import ShiftedConfig
from test_torch_shifted import compare

torch.set_num_threads(1)

SIGMA = np.array([0.0, 0.05, 0.2, 1.0, 4.0])
SEED = 4
TOL = 1e-10


def _problems(dtype):
    args = (120, [1, -1, 10, -10])
    csr = tgen.banded_random(*args, seed=11)
    pj = jprob.build_problem(jgen.banded_random(*args, seed=11), dtype=dtype,
                             sigma_seed=float(SIGMA[SEED]))
    pt = tprob.build_problem(csr, dtype=dtype, multiple=1, device="cpu",
                             sigma_seed=float(SIGMA[SEED]))
    return csr, pj, pt


def _jcfg(dtype, **kw):
    return jcfg.ShiftedConfig(dtype="df32" if dtype == "df32"
                              else np.float64, **kw)


@pytest.mark.parametrize("dtype", ["float64", "df32"])
@pytest.mark.parametrize("method", ["shifted_lopbicg",
                                    "shifted_lopbicg_switching"])
def test_switching_family_matches_jax(method, dtype):
    csr, pj, pt = _problems(dtype)
    rj = japi.solve_shifted(pj.A, pj.b, SIGMA, seed=SEED, method=method,
                            cfg=_jcfg(dtype, tol=TOL, max_iter=400))
    before = csu.fused_shift_update_df.launches
    rt = tapi.solve_shifted(pt.A, pt.b, SIGMA, seed=SEED, method=method,
                            cfg=ShiftedConfig(tol=TOL, max_iter=400,
                                              dtype=dtype))
    # on the CPU a DF state takes the kernel's plain twin: no launch
    assert csu.fused_shift_update_df.launches == before
    assert bool(rt.stop_flags.all())
    compare(rj, rt, csr, SIGMA, dtype, TOL, sigma_seed=SIGMA[SEED])
    if method == "shifted_lopbicg_switching":
        # the fixture switches in both packages
        assert rt.final_seed != SEED and int(rj.final_seed) != SEED


def test_df32_switching_takes_the_fused_update_every_iteration(monkeypatch):
    """A DF state goes through fused_shift_update_df once per iteration,
    on the CPU as on the card (the wrapper picks twin or kernel)."""
    _, _, pt = _problems("df32")
    cfg = ShiftedConfig(tol=TOL, max_iter=400, dtype="df32")
    calls = []
    real = csu.fused_shift_update_df

    def spy(*args):
        calls.append(1)
        return real(*args)

    import mpi_bicgstab_tpu_torch.solvers.switching as tsw
    monkeypatch.setattr(tsw, "fused_shift_update_df", spy)
    res = tapi.solve_shifted(pt.A, pt.b, SIGMA, seed=SEED,
                             method="shifted_lopbicg_switching", cfg=cfg)
    assert len(calls) == res.n_iter


@pytest.mark.parametrize("L", [4, 7])
def test_blocked_matches_jax_blocked(L):
    csr, pj, pt = _problems("float64")
    rj = japi.solve_shifted(pj.A, pj.b, SIGMA, seed=SEED,
                            method="shifted_lopbicg_switching",
                            cfg=_jcfg("float64", tol=TOL, max_iter=400,
                                      shift_block=L))
    rt = tapi.solve_shifted(pt.A, pt.b, SIGMA, seed=SEED,
                            method="shifted_lopbicg_switching",
                            cfg=ShiftedConfig(tol=TOL, max_iter=400,
                                              shift_block=L))
    assert bool(rt.stop_flags.all()) and rt.final_seed != SEED
    compare(rj, rt, csr, SIGMA, "float64", TOL, sigma_seed=SIGMA[SEED])


def test_blocked_float32_matches_per_iteration():
    csr, _, pt = _problems("float32")
    cfgs = [ShiftedConfig(tol=1e-5, max_iter=200, dtype="float32",
                          shift_block=sb) for sb in (0, 5)]
    r0, rb = (tapi.solve_shifted(pt.A, pt.b, SIGMA, seed=SEED,
                                 method="shifted_lopbicg_switching", cfg=c)
              for c in cfgs)
    assert abs(r0.n_iter - rb.n_iter) <= 2 and r0.final_seed == rb.final_seed
    np.testing.assert_allclose(rb.x_set.double().numpy(),
                               r0.x_set.double().numpy(), atol=1e-4)


def test_resolve_block_rules():
    b32 = torch.ones(4, dtype=torch.float32)
    from mpi_bicgstab_tpu_torch.ops.precision import df_from_f64
    bdf = df_from_f64(np.ones(4))
    auto = ShiftedConfig(dtype="float32", max_iter=100)
    assert resolve_block(auto, b32, 512) == 0          # the CPU: per-iteration
    assert resolve_block(auto.replace(shift_block=0), b32, 512) == 0
    assert resolve_block(auto.replace(shift_block=16), b32, 512) == 16
    assert resolve_block(auto.replace(shift_block=500), b32, 512) == 100
    assert resolve_block(auto, bdf, 512) == 0
    with pytest.raises(ValueError, match="df32"):
        resolve_block(auto.replace(shift_block=8), bdf, 512)


def test_blocked_refuses_tf32():
    _, _, pt = _problems("float64")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            tapi.solve_shifted(pt.A, pt.b, SIGMA, seed=SEED,
                               method="shifted_lopbicg_switching",
                               cfg=ShiftedConfig(tol=TOL, shift_block=4))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert torch.backends.cuda.matmul.allow_tf32 == old


@pytest.mark.parametrize("shift_block", [0, 3])
def test_tol0_neither_stops_nor_switches(shift_block):
    _, _, pt = _problems("float64")
    res = tapi.solve_shifted(pt.A, pt.b, SIGMA, seed=SEED,
                             method="shifted_lopbicg_switching",
                             cfg=ShiftedConfig(tol=0.0, max_iter=25,
                                               shift_block=shift_block))
    assert res.n_iter == 25 and res.final_seed == SEED
    assert not bool(res.stop_flags.any())


def test_verbose_switch_prints_the_switch():
    _, _, pt = _problems("float64")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = tapi.solve_shifted(pt.A, pt.b, SIGMA, seed=SEED,
                                 method="shifted_lopbicg_switching",
                                 cfg=ShiftedConfig(tol=TOL, out_iter=5,
                                                   verbose_switch=True))
    text = out.getvalue()
    assert f"seed {SEED} -> " in text and "iter 5: seed relres" in text
    assert res.final_seed != SEED
