"""Port vs JAX package: the fused classic-BiCGStab passes K1, K2, K3 and
the float32 solve over them.

The port's plain twins (what its wrappers run for CPU tensors) against
the JAX Pallas kernels run with interpret=True, on the same NumPy inputs.
Tolerances: vectors rtol 1e-5 / atol 1e-4, dots rtol 1e-4 (float32; the
two sides sum the band and the dots in different orders). Solves: n_iter
within +-2 of JAX, converged, max|x-1| < 1e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.api as japi
import mpi_bicgstab_tpu.models.generators as jgen
import mpi_bicgstab_tpu.models.problem as jprob
import mpi_bicgstab_tpu.ops.pallas_fused_classic as jfcl
import mpi_bicgstab_tpu.utils.config as jcfg
import mpi_bicgstab_tpu_torch.api as tapi
import mpi_bicgstab_tpu_torch.models.generators as tgen
import mpi_bicgstab_tpu_torch.models.problem as tprob
import mpi_bicgstab_tpu_torch.ops.cuda_fused_classic as tfcl
from mpi_bicgstab_tpu_torch import convert
from mpi_bicgstab_tpu_torch.utils.config import SolverConfig

torch.set_num_threads(1)

VEC = {"rtol": 1e-5, "atol": 1e-4}
DOT = {"rtol": 1e-4}
_GRID = 8192        # the JAX kernels' row-tile grid (64 x 128 rows)

CASES = {
    "narrow": (16384, [1, -1, 40, -40, 129, -129], 11),
    "wide": (16384, [1, -1, 9000, -9000], 7),       # halo > one JAX tile
    "n5000": (5000, [1, -1, 30, -30], 13),          # not a grid multiple
}


def _setup(case):
    """JAX operator, the port's operator carried across from its arrays,
    and random inputs, all padded with inert zero rows to the JAX grid
    (the port itself runs at the logical n)."""
    n, offsets, seed = CASES[case]
    pj = jprob.build_problem(jgen.banded_random(n, offsets, seed=seed),
                             dtype=jnp.float32, multiple=_GRID)
    A = pj.A
    At = convert.operator_from_arrays(
        "dia", {"vals": np.asarray(A.vals)[:, :n]},
        {"offsets": A.offsets, "n": n}, device="cpu")
    rng = np.random.default_rng(3)
    vecs = {}
    for name in ("r", "p", "s", "rh", "x", "q", "y"):
        v = np.zeros(A.n_rows, np.float32)
        v[:n] = rng.standard_normal(n)
        vecs[name] = v
    return n, A, At, vecs


def _t(v, n):
    return torch.from_numpy(v[:n].copy())


def _sc(*vals):
    return tuple(torch.tensor(v, dtype=torch.float32) for v in vals)


def _cmp_vec(got, want, n):
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:n], **VEC)
    np.testing.assert_array_equal(np.asarray(want)[n:], 0.0)  # inert pad


def _cmp_dot(got, want):
    np.testing.assert_allclose(float(got), float(want), **DOT)


@pytest.mark.parametrize("case", list(CASES))
def test_k1_matches_jax_interpret(case):
    n, A, At, v = _setup(case)
    j = jfcl.fused_k1(A.vals, *(jnp.asarray(v[k]) for k in "rps"),
                      jnp.asarray(v["rh"]), jnp.asarray([0.3, 0.2],
                                                        jnp.float32),
                      A.offsets, interpret=True)
    t = tfcl.fused_k1(At.vals, *(_t(v[k], n) for k in "rps"),
                      _t(v["rh"], n), _sc(0.3, 0.2), At.offsets)
    _cmp_vec(t[0], j[0], n)
    _cmp_vec(t[1], j[1], n)
    _cmp_dot(t[2], j[2])


@pytest.mark.parametrize("case", list(CASES))
def test_k2_matches_jax_interpret(case):
    n, A, At, v = _setup(case)
    j = jfcl.fused_k2(A.vals, jnp.asarray(v["r"]), jnp.asarray(v["s"]),
                      jnp.asarray([0.7], jnp.float32), A.offsets,
                      interpret=True)
    t = tfcl.fused_k2(At.vals, _t(v["r"], n), _t(v["s"], n), _sc(0.7),
                      At.offsets)
    _cmp_vec(t[0], j[0], n)
    _cmp_vec(t[1], j[1], n)
    _cmp_dot(t[2], j[2])
    _cmp_dot(t[3], j[3])


@pytest.mark.parametrize("case", list(CASES))
def test_k3_matches_jax_interpret(case):
    n, A, At, v = _setup(case)
    names = ("x", "p", "q", "y", "rh")
    j = jfcl.fused_k3(*(jnp.asarray(v[k]) for k in names),
                      jnp.asarray([0.7, 0.2], jnp.float32), interpret=True)
    t = tfcl.fused_k3(*(_t(v[k], n) for k in names), _sc(0.7, 0.2))
    _cmp_vec(t[0], j[0], n)
    _cmp_vec(t[1], j[1], n)
    _cmp_dot(t[2], j[2])
    _cmp_dot(t[3], j[3])


SOLVES = [(8192, [1, -1, 40, -40], 12), (5000, [1, -1, 30, -30], 13)]
_CFG_J = jcfg.SolverConfig(tol=1e-5, max_iter=200, dtype=jnp.float32)


def _port_solve(n, offsets, seed):
    """The port's float32 solve on the CPU: the fused route, plain twins."""
    pt = tprob.build_problem(tgen.banded_random(n, offsets, seed=seed),
                             dtype="float32", device="cpu")
    assert tfcl.format_ok(pt.A, torch.float32)
    res = tapi.solve(pt.A, pt.b,
                     cfg=SolverConfig(tol=1e-5, max_iter=200,
                                      dtype="float32"))
    assert bool(res.converged)
    assert float((res.x.double() - 1.0).abs().max()) < 1e-3
    assert res.x.dtype == torch.float32 and res.x.shape == (n,)
    hist = res.history.numpy()
    assert np.isfinite(hist[:res.n_iter]).all()
    assert np.isnan(hist[res.n_iter:]).all()
    return res


def _jax_problem(n, offsets, seed):
    return jprob.build_problem(jgen.banded_random(n, offsets, seed=seed),
                               dtype=jnp.float32, multiple=_GRID)


@pytest.mark.parametrize("n,offsets,seed", SOLVES)
def test_f32_solve_matches_jax_fused_interpret(n, offsets, seed):
    pj = _jax_problem(n, offsets, seed)
    ref = jfcl.bicgstab_fused(pj.A, pj.b, jnp.zeros_like(pj.b), _CFG_J,
                              interpret=True)
    assert bool(ref.converged)
    assert abs(_port_solve(n, offsets, seed).n_iter - int(ref.n_iter)) <= 2


@pytest.mark.parametrize("n,offsets,seed", SOLVES)
def test_f32_solve_matches_jax_api(n, offsets, seed):
    pj = _jax_problem(n, offsets, seed)
    ref = japi.solve(pj.A, pj.b, method="bicgstab", cfg=_CFG_J)
    assert bool(ref.converged)
    assert abs(_port_solve(n, offsets, seed).n_iter - int(ref.n_iter)) <= 2


def test_fused_route_needs_no_padding():
    """Zero rows are inert: padding the port's problem does not change
    the iterates on the logical rows."""
    csr = tgen.banded_random(3000, [1, -1, 25, -25], seed=4)
    cfg = SolverConfig(tol=1e-5, max_iter=100, dtype="float32")
    res = []
    for multiple in (1, 1024):
        p = tprob.build_problem(csr, dtype="float32", multiple=multiple,
                                device="cpu")
        res.append(tapi.solve(p.A, p.b, cfg=cfg))
    assert res[0].n_iter == res[1].n_iter
    np.testing.assert_allclose(res[0].x.numpy(), res[1].x[:3000].numpy(),
                               rtol=1e-5, atol=1e-6)
    assert not res[1].x[3000:].any()
