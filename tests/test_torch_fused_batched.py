"""Port vs JAX package: the batched DIA SpMV and the fused batched
classic passes K1b, K2b, K3b, pass by pass.

The port's plain twins (what its wrappers run for CPU tensors) against
the JAX Pallas kernels run with interpret=True, on the same NumPy inputs.
The JAX kernels want n a multiple of 8192 and their fused passes a padded
carry (pad_carry_b, _margin_tiles); that layout is built on the JAX side
only. Cases: k = 1, 3 and 8 lanes, a narrow band and a wide one (a halo
wider than one JAX row tile), frozen lanes (active = 0) whose outputs
must come back bit-unchanged on both sides, and JAX's multi-chunk stash
path (MBT_BATCHED_CH=1 at n = 16384). Tolerances: vectors rtol 1e-5 /
atol 1e-4; dots rtol 1e-4 with JAX's atol 1e-3 (a dot of independent
random planes cancels n terms of size ~1 down to ~1; the two sides sum
in different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.models.generators as jgen
import mpi_bicgstab_tpu.models.problem as jprob
import mpi_bicgstab_tpu.ops.pallas_batched_spmv as jbs
import mpi_bicgstab_tpu.ops.pallas_fused_batched as jfb
import mpi_bicgstab_tpu_torch.ops.cuda_batched_spmv as tbs
import mpi_bicgstab_tpu_torch.ops.cuda_fused_batched as tfb
from mpi_bicgstab_tpu_torch import convert

torch.set_num_threads(1)

VEC = {"rtol": 1e-5, "atol": 1e-4}
DOT = {"rtol": 1e-4, "atol": 1e-3}
_GRID = 8192        # the JAX kernels' row-tile grid (64 x 128 rows)

# name: (n, offsets, k, frozen lanes). The JAX kernels' interpret-mode
# compile time grows with k times the band, so the 8-lane case takes a
# short band.
CASES = {
    "narrow_k1": (8192, [1, -1, 40, -40, 129, -129], 1, ()),
    "narrow_k3": (8192, [1, -1, 40, -40, 129, -129], 3, (1,)),
    "wide_k3": (16384, [1, -1, 9000, -9000], 3, (0,)),  # halo > one tile
    "k8": (8192, [-129], 8, (0, 5)),
}
# JAX's multi-chunk stash path (test_passes_match_jax_multichunk_stash)
STASH = (16384, [1, -1, 40, -40], 2, (1,))


def _setup(case, seed=3):
    """JAX operator, the port's operator carried across from its arrays,
    random [k, n] planes and per-lane scalars (alpha, beta, omega, active)
    as NumPy float32."""
    n, offsets, k, frozen = STASH if case == "stash" else CASES[case]
    A = jprob.build_problem(jgen.banded_random(n, offsets, seed=11),
                            dtype=jnp.float32, multiple=_GRID).A
    At = convert.operator_from_arrays("dia", {"vals": np.asarray(A.vals)},
                                      {"offsets": A.offsets, "n": n},
                                      device="cpu")
    rng = np.random.default_rng(seed)
    planes = {name: rng.standard_normal((k, n)).astype(np.float32)
              for name in ("r", "p", "s", "rh", "x", "q", "y")}
    a, b, w = (rng.uniform(0.1, 0.9, k).astype(np.float32)
               for _ in range(3))
    act = np.ones(k, np.float32)
    act[list(frozen)] = 0.0
    return A, At, planes, (a, b, w, act), list(frozen)


def _jax_carry(A, v):
    """A [k, n] plane in the JAX fused passes' padded-carry layout."""
    nr = v.shape[1] // 128
    return jfb.pad_carry_b(jnp.asarray(v), nr, jfb._margin_tiles(A.offsets))


def _jax_unpad(A, vp, n):
    return np.asarray(jfb.unpad_carry_b(
        vp, n // 128, jfb._margin_tiles(A.offsets)))


def _flat(*per_lane):
    """JAX's scalar vector: lane j's values in turn."""
    return jnp.asarray(np.stack(per_lane, axis=1).reshape(-1), jnp.float32)


def _t(v):
    return torch.from_numpy(v.copy())


def _cmp(got, want, k, n):
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(k, n),
                               **VEC)


def _cmp_dots(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DOT)


def _frozen_kept(got, want, old, frozen, k, n):
    """The frozen lanes' outputs are their old values, bit for bit, in
    both packages."""
    np.testing.assert_array_equal(got.numpy()[frozen], old[frozen])
    np.testing.assert_array_equal(np.asarray(want).reshape(k, n)[frozen],
                                  old[frozen])


@pytest.mark.parametrize("case", list(CASES))
def test_batched_spmv_matches_jax_interpret(case):
    A, At, v, _, _ = _setup(case)
    k, n = v["x"].shape
    want = jbs.batched_dia_spmv(A.vals, jnp.asarray(v["x"]), A.offsets,
                                interpret=True)
    got = tbs.batched_dia_spmv(At.vals, At.offsets, _t(v["x"]))
    _cmp(got, want, k, n)


def _k1b(case):
    A, At, v, (a, b, w, act), frozen = _setup(case)
    k, n = v["r"].shape
    nr = n // 128
    j = jfb.fused_k1b(A.vals.reshape(len(A.offsets), nr, 128),
                      _jax_carry(A, v["r"]), _jax_carry(A, v["p"]),
                      _jax_carry(A, v["s"]),
                      jnp.asarray(v["rh"]).reshape(k, nr, 128),
                      _flat(b, w, act), A.offsets,
                      jfb._margin_tiles(A.offsets), interpret=True)
    t = tfb.fused_k1b(At.vals, *(_t(v[x]) for x in ("r", "p", "s", "rh")),
                      (_t(b), _t(w), _t(act)), At.offsets)
    P2, S2 = _jax_unpad(A, j[0], n), _jax_unpad(A, j[1], n)
    _cmp(t[0], P2, k, n)
    _cmp(t[1], S2, k, n)
    _cmp_dots(t[2], j[2])
    _frozen_kept(t[0], P2, v["p"], frozen, k, n)
    _frozen_kept(t[1], S2, v["s"], frozen, k, n)


def _k2b(case):
    A, At, v, (a, b, w, act), frozen = _setup(case)
    k, n = v["r"].shape
    nr = n // 128
    # the solver loop runs a frozen lane with alpha = 0: q = r exactly
    a = np.where(act > 0, a, np.float32(0))
    j = jfb.fused_k2b(A.vals.reshape(len(A.offsets), nr, 128),
                      _jax_carry(A, v["r"]), _jax_carry(A, v["s"]),
                      _flat(a, np.zeros_like(a)), A.offsets,
                      jfb._margin_tiles(A.offsets), interpret=True)
    t = tfb.fused_k2b(At.vals, _t(v["r"]), _t(v["s"]), (_t(a),),
                      At.offsets)
    for i in range(2):
        _cmp(t[i], j[i], k, n)
    _cmp_dots(t[2], j[2])
    _cmp_dots(t[3], j[3])
    _frozen_kept(t[0], j[0], v["r"], frozen, k, n)


@pytest.mark.parametrize("case", list(CASES))
def test_k1b_matches_jax_interpret(case):
    _k1b(case)


@pytest.mark.parametrize("case", list(CASES))
def test_k2b_matches_jax_interpret(case):
    _k2b(case)


@pytest.mark.parametrize("case", list(CASES))
def test_k3b_matches_jax_interpret(case):
    A, At, v, (a, b, w, act), frozen = _setup(case)
    k, n = v["x"].shape
    nr = n // 128
    planes3 = {x: jnp.asarray(v[x]).reshape(k, nr, 128)
               for x in ("x", "q", "y", "rh")}
    j = jfb.fused_k3b(planes3["x"], _jax_carry(A, v["p"]), planes3["q"],
                      planes3["y"], planes3["rh"], _flat(a, w, act),
                      A.offsets, jfb._margin_tiles(A.offsets),
                      interpret=True)
    t = tfb.fused_k3b(*(_t(v[x]) for x in ("x", "p", "q", "y", "rh")),
                      (_t(a), _t(w), _t(act)))
    R2 = _jax_unpad(A, j[1], n)
    _cmp(t[0], j[0], k, n)
    _cmp(t[1], R2, k, n)
    _cmp_dots(t[2], j[2])
    _cmp_dots(t[3], j[3])
    _frozen_kept(t[0], j[0], v["x"], frozen, k, n)
    _frozen_kept(t[1], R2, v["q"], frozen, k, n)


@pytest.mark.parametrize("run", [_k1b, _k2b], ids=["k1b", "k2b"])
def test_passes_match_jax_multichunk_stash(run, monkeypatch):
    """JAX's forced one-tile chunks (MBT_BATCHED_CH=1): K1b then writes its
    outputs over its inputs chunk by chunk and feeds each next window's
    head from its VMEM stash. The port, which writes fresh outputs, must
    agree with that path too."""
    monkeypatch.setenv("MBT_BATCHED_CH", "1")
    run("stash")
