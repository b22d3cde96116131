"""Port vs JAX package: the fused CA-BiCGStab passes K1, K2 and the
float32 solve over them.

The port's plain twins (what its wrappers run for CPU tensors) against
the JAX Pallas kernels run with interpret=True, on the same NumPy inputs.
Tolerances: vectors rtol 1e-5 / atol 1e-4, dots rtol 1e-4 (float32; the
two sides sum the band and the dots in different orders) with atol 1e-3,
the JAX package's own bound for these kernels (tests/test_fused_pipe.py,
test_ca_k1_k2_match_xla): a dot of two independent random vectors, such
as (r^, s'), cancels n terms of size ~1 down to ~1, so its rounding error
follows the terms (~7e-5 at n = 16384), not the result. Solves: n_iter
within +-2 of JAX, converged, max|x-1| < 1e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.api as japi
import mpi_bicgstab_tpu.models.generators as jgen
import mpi_bicgstab_tpu.models.problem as jprob
import mpi_bicgstab_tpu.ops.pallas_fused_ca as jfca
import mpi_bicgstab_tpu.utils.config as jcfg
import mpi_bicgstab_tpu_torch.api as tapi
import mpi_bicgstab_tpu_torch.models.generators as tgen
import mpi_bicgstab_tpu_torch.models.problem as tprob
import mpi_bicgstab_tpu_torch.ops.cuda_fused_ca as tfca
from mpi_bicgstab_tpu_torch import convert
from mpi_bicgstab_tpu_torch.utils.config import SolverConfig

torch.set_num_threads(1)

VEC = {"rtol": 1e-5, "atol": 1e-4}
DOT = {"rtol": 1e-4, "atol": 1e-3}
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
    for name in ("r", "p", "s", "w", "z", "x", "rh", "q", "y"):
        v = np.zeros(A.n_rows, np.float32)
        v[:n] = rng.standard_normal(n)
        vecs[name] = v
    return n, A, At, vecs


def _t(v, n):
    return torch.from_numpy(v[:n].copy())


def _sc(*vals):
    return tuple(torch.tensor(v, dtype=torch.float32) for v in vals)


def _cmp(got, want, n, n_vec):
    for g, w in zip(got[:n_vec], want[:n_vec]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:n], **VEC)
        np.testing.assert_array_equal(np.asarray(w)[n:], 0.0)  # inert pad
    assert len(got) == len(want)
    for g, w in zip(got[n_vec:], want[n_vec:]):
        np.testing.assert_allclose(float(g), float(w), **DOT)


@pytest.mark.parametrize("case", list(CASES))
def test_ca_k1_matches_jax_interpret(case):
    n, A, At, v = _setup(case)
    names = ("r", "p", "s", "w", "z")
    j = jfca.fused_ca_k1(A.vals, *(jnp.asarray(v[k]) for k in names),
                         jnp.asarray([0.7, 0.3, 0.2], jnp.float32),
                         A.offsets, interpret=True)
    t = tfca.fused_ca_k1(At.vals, *(_t(v[k], n) for k in names),
                         _sc(0.7, 0.3, 0.2), At.offsets)
    _cmp(t, j, n, 5)


@pytest.mark.parametrize("case", list(CASES))
def test_ca_k2_matches_jax_interpret(case):
    n, A, At, v = _setup(case)
    names = ("q", "y", "x", "p", "rh", "s", "z")
    j = jfca.fused_ca_k2(A.vals, *(jnp.asarray(v[k]) for k in names),
                         jnp.asarray([0.7, 0.2], jnp.float32), A.offsets,
                         interpret=True)
    t = tfca.fused_ca_k2(At.vals, *(_t(v[k], n) for k in names),
                         _sc(0.7, 0.2), At.offsets)
    _cmp(t, j, n, 3)


SOLVES = [(8192, [1, -1, 40, -40], 22), (5000, [1, -1, 30, -30], 13)]
_CFG_J = jcfg.SolverConfig(tol=1e-5, max_iter=200, dtype=jnp.float32)


def _port_solve(n, offsets, seed):
    """The port's float32 CA solve on the CPU: the fused route, plain
    twins."""
    pt = tprob.build_problem(tgen.banded_random(n, offsets, seed=seed),
                             dtype="float32", device="cpu")
    res = tapi.solve(pt.A, pt.b, method="ca_bicgstab",
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
def test_ca_solve_matches_jax_fused_interpret(n, offsets, seed):
    pj = _jax_problem(n, offsets, seed)
    ref = jfca.ca_bicgstab_fused(pj.A, pj.b, jnp.zeros_like(pj.b), _CFG_J,
                                 interpret=True)
    assert bool(ref.converged)
    assert abs(_port_solve(n, offsets, seed).n_iter - int(ref.n_iter)) <= 2


@pytest.mark.parametrize("n,offsets,seed", SOLVES)
def test_ca_solve_matches_jax_api(n, offsets, seed):
    pj = _jax_problem(n, offsets, seed)
    ref = japi.solve(pj.A, pj.b, method="ca_bicgstab", cfg=_CFG_J)
    assert bool(ref.converged)
    assert abs(_port_solve(n, offsets, seed).n_iter - int(ref.n_iter)) <= 2
