"""Port vs JAX package: the fused pipelined-BiCGStab phases A and B and
the float32 pipe_bicgstab / pipe_bicgstab_rr solves over them.

The port's plain twins (what its wrappers run for CPU tensors) against
the JAX Pallas kernels run with interpret=True, on the same NumPy inputs.
Tolerances: vectors rtol 1e-5 / atol 1e-4, dots rtol 1e-4 with atol 1e-3
(float32; the two sides sum the band and the dots in different orders,
and a dot of two independent random vectors cancels n terms of size ~1
down to ~1, so its rounding error follows the terms; the JAX package
holds these kernels to the same bound, tests/test_fused_pipe.py).
Solves: n_iter within +-2 of JAX, converged, max|x-1| < 1e-3. The RR
solve is held to the JAX package's api.solve (its fused RR solver in
interpret mode is too slow for this tier).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.api as japi
import mpi_bicgstab_tpu.models.generators as jgen
import mpi_bicgstab_tpu.models.problem as jprob
import mpi_bicgstab_tpu.ops.pallas_fused_pipe as jfp
import mpi_bicgstab_tpu.utils.config as jcfg
import mpi_bicgstab_tpu_torch.api as tapi
import mpi_bicgstab_tpu_torch.models.generators as tgen
import mpi_bicgstab_tpu_torch.models.problem as tprob
import mpi_bicgstab_tpu_torch.ops.cuda_fused_pipe as tfp
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
    rng = np.random.default_rng(4)
    vecs = {}
    for name in ("zn", "r", "p", "s", "w", "z", "x", "q", "y", "rh"):
        v = np.zeros(A.n_rows, np.float32)
        v[:n] = rng.standard_normal(n)
        vecs[name] = v
    return n, A, At, vecs


def _t(v, n):
    return torch.from_numpy(v[:n].copy())


def _sc(*vals):
    return tuple(torch.tensor(v, dtype=torch.float32) for v in vals)


def _cmp(got, want, n, n_vec):
    assert len(got) == len(want)
    for g, w in zip(got[:n_vec], want[:n_vec]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:n], **VEC)
        np.testing.assert_array_equal(np.asarray(w)[n:], 0.0)  # inert pad
    for g, w in zip(got[n_vec:], want[n_vec:]):
        np.testing.assert_allclose(float(g), float(w), **DOT)


@pytest.mark.parametrize("case", list(CASES))
def test_phase_a_matches_jax_interpret(case):
    n, A, At, v = _setup(case)
    names = ("zn", "r", "p", "s", "w", "z")
    j = jfp.fused_phase_a(A.vals, *(jnp.asarray(v[k]) for k in names),
                          jnp.asarray([0.7, 0.3, 0.2], jnp.float32),
                          A.offsets, interpret=True)
    t = tfp.fused_phase_a(At.vals, *(_t(v[k], n) for k in names),
                          _sc(0.7, 0.3, 0.2), At.offsets)
    _cmp(t, j, n, 5)


@pytest.mark.parametrize("case", list(CASES))
def test_phase_b_matches_jax_interpret(case):
    n, A, At, v = _setup(case)
    names = ("w", "x", "p", "q", "y", "rh", "s", "z")
    j = jfp.fused_phase_b(A.vals, *(jnp.asarray(v[k]) for k in names),
                          jnp.asarray([0.7, 0.2], jnp.float32), A.offsets,
                          interpret=True)
    t = tfp.fused_phase_b(At.vals, *(_t(v[k], n) for k in names),
                          _sc(0.7, 0.2), At.offsets)
    _cmp(t, j, n, 3)


SOLVES = [(8192, [1, -1, 40, -40], 12), (5000, [1, -1, 30, -30], 13)]


def _port_solve(n, offsets, seed, method, **cfg):
    """The port's float32 solve on the CPU: the fused route, plain
    twins."""
    pt = tprob.build_problem(tgen.banded_random(n, offsets, seed=seed),
                             dtype="float32", device="cpu")
    res = tapi.solve(pt.A, pt.b, method=method,
                     cfg=SolverConfig(tol=1e-5, max_iter=200,
                                      dtype="float32", **cfg))
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
def test_pipe_solve_matches_jax_fused_interpret(n, offsets, seed):
    pj = _jax_problem(n, offsets, seed)
    cfg = jcfg.SolverConfig(tol=1e-5, max_iter=200, dtype=jnp.float32)
    ref = jfp.pipe_bicgstab_fused(pj.A, pj.b, jnp.zeros_like(pj.b), cfg,
                                  interpret=True)
    assert bool(ref.converged)
    got = _port_solve(n, offsets, seed, "pipe_bicgstab")
    assert abs(got.n_iter - int(ref.n_iter)) <= 2


@pytest.mark.parametrize("n,offsets,seed", SOLVES)
def test_pipe_solve_matches_jax_api(n, offsets, seed):
    pj = _jax_problem(n, offsets, seed)
    ref = japi.solve(pj.A, pj.b, method="pipe_bicgstab",
                     cfg=jcfg.SolverConfig(tol=1e-5, max_iter=200,
                                           dtype=jnp.float32))
    assert bool(ref.converged)
    got = _port_solve(n, offsets, seed, "pipe_bicgstab")
    assert abs(got.n_iter - int(ref.n_iter)) <= 2


@pytest.mark.parametrize("n,offsets,seed", [(8192, [1, -1, 40, -40], 23),
                                            (5000, [1, -1, 30, -30], 13)])
def test_pipe_rr_solve_matches_jax_api_and_rr_fires(n, offsets, seed,
                                                    monkeypatch):
    """krr = 3, nrr = 2: iterations 3 and 6 are replacements, which run
    no phase kernel; every other iteration runs phase A and B once."""
    calls = {"a": 0, "b": 0}
    for key, name in (("a", "fused_phase_a"), ("b", "fused_phase_b")):
        def spy(*args, _fn=getattr(tfp, name), _key=key):
            calls[_key] += 1
            return _fn(*args)
        monkeypatch.setattr(tfp, name, spy)
    pj = _jax_problem(n, offsets, seed)
    ref = japi.solve(pj.A, pj.b, method="pipe_bicgstab_rr",
                     cfg=jcfg.SolverConfig(tol=1e-5, max_iter=200, krr=3,
                                           nrr=2, dtype=jnp.float32))
    assert bool(ref.converged)
    got = _port_solve(n, offsets, seed, "pipe_bicgstab_rr", krr=3, nrr=2)
    assert abs(got.n_iter - int(ref.n_iter)) <= 2
    assert got.n_iter > 6                      # both replacements fired
    assert calls == {"a": got.n_iter - 2, "b": got.n_iter - 2}


def test_rr_iteration_matches_the_unfused_solver():
    """The fused driver, replacement iterations included, against the
    unfused pipe_bicgstab_rr: the same update order, so in float64 (the
    plain twins take any dtype on the CPU) they agree to rounding."""
    from mpi_bicgstab_tpu_torch.parallel.comm import Comm
    from mpi_bicgstab_tpu_torch.solvers.bicgstab import pipe_bicgstab_rr
    pt = tprob.build_problem(tgen.banded_random(4000, [1, -1, 25, -25],
                                                seed=6),
                             dtype="float64", device="cpu")
    cfg = SolverConfig(tol=0.0, max_iter=7, krr=2, nrr=3)
    fused = tfp.pipe_bicgstab_rr_fused(pt.A, pt.b, pt.x0, cfg)
    plain = pipe_bicgstab_rr(lambda v: tapi.generic_spmv(pt.A, v), Comm(),
                             pt.b, pt.x0, cfg)
    np.testing.assert_allclose(fused.history.numpy(),
                               plain.history.numpy(), rtol=1e-10)
    np.testing.assert_allclose(fused.x.numpy(), plain.x.numpy(),
                               rtol=1e-12)
