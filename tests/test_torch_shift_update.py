"""Port vs JAX package: the fused df32 shift update (ops/cuda_shift_update.py,
kernel csrc/shift_update_df.cu; JAX ops/pallas_shift_update.py).

The plain twin (what the wrapper runs for CPU tensors) is held to the JAX
Pallas kernel run in interpret mode and to the XLA formulas of
tests/test_shift_update_kernel.py, on the same DF inputs from a seeded
NumPy generator with the active mask folded into the coefficients:
within 1e-13 (the JAX package computes its DF operations on the CPU
through float64, the port with the error-free transformations), frozen
rows bit-equal to their inputs. The kernel itself is held bit-equal to
the twin on the card (tests/test_torch_kernels.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.ops.precision as jp
from mpi_bicgstab_tpu.ops.pallas_shift_update import \
    fused_shift_update_df as jax_fused
from mpi_bicgstab_tpu_torch import convert
from mpi_bicgstab_tpu_torch.ops import cuda_shift_update as csu
from test_shift_update_kernel import _xla_reference

torch.set_num_threads(1)


def _inputs(S, n, frozen_share=0.3, seed=0):
    """JAX DF inputs (x, p, q, r_old, r_new, six folded coefficients) and
    the port's copies; the mask as a bool array."""
    rng = np.random.default_rng(seed)
    mk = lambda shape: jp.df_from_f64(rng.standard_normal(shape))  # noqa
    x, p = mk((S, n)), mk((S, n))
    q, ro, rn = mk(n), mk(n), mk(n)
    raw = [mk(S) for _ in range(6)]
    active = rng.random(S) >= frozen_share
    zero, one = jp.df_from_f64(np.zeros(S)), jp.df_from_f64(np.ones(S))
    ja = jnp.asarray(active)
    coefs = [jp.df_where(ja, c, one if i == 4 else zero)
             for i, c in enumerate(raw)]
    jv = [x, p, q, ro, rn, *coefs]
    tv = [convert.df_from_arrays(np.asarray(v.hi), np.asarray(v.lo),
                                 device="cpu") for v in jv]
    return jv, tv, active


def _f64(v):
    return v.hi.double().numpy() + v.lo.double().numpy()


@pytest.mark.parametrize("S,n", [(16, 512), (8, 1024)])
def test_twin_matches_jax_kernel_and_xla(S, n):
    jv, tv, active = _inputs(S, n)
    x2, p2 = csu.fused_shift_update_df_plain(*tv)
    kx, kp = jax_fused(*jv, interpret=True)
    xx, xp = _xla_reference(*jv[:5], tuple(jv[5:]), jnp.asarray(active))
    for got, wants in ((x2, (kx, xx)), (p2, (kp, xp))):
        for want in wants:
            np.testing.assert_allclose(_f64(got), jp.df_to_f64(want),
                                       rtol=1e-13, atol=1e-13)
    frozen = ~active
    assert frozen.any() and active.any()
    for got, src in ((x2, tv[0]), (p2, tv[1])):
        assert torch.equal(got.hi[frozen], src.hi[frozen])
        assert torch.equal(got.lo[frozen], src.lo[frozen])


@pytest.mark.parametrize("S,n", [(5, 37), (1, 1), (3, 130)])
def test_twin_takes_ragged_shapes(S, n):
    """No TPU gate (S % 8, n % 128) carries over: any S and n."""
    jv, tv, active = _inputs(S, n, frozen_share=0.4, seed=S + n)
    x2, p2 = csu.fused_shift_update_df_plain(*tv)
    xx, xp = _xla_reference(*jv[:5], tuple(jv[5:]), jnp.asarray(active))
    np.testing.assert_allclose(_f64(x2), jp.df_to_f64(xx), rtol=1e-13,
                               atol=1e-13)
    np.testing.assert_allclose(_f64(p2), jp.df_to_f64(xp), rtol=1e-13,
                               atol=1e-13)


def test_cpu_state_takes_the_twin_in_place_and_counts_no_launch():
    jv, tv, _ = _inputs(6, 200)
    want_x, want_p = csu.fused_shift_update_df_plain(*tv)
    x, p = tv[0], tv[1]
    x_hi, p_lo = x.hi, p.lo
    before = csu.fused_shift_update_df.launches
    got_x, got_p = csu.fused_shift_update_df(*tv)
    assert csu.fused_shift_update_df.launches == before
    assert got_x is x and got_p is p                   # the same pairs
    assert got_x.hi is x_hi and got_p.lo is p_lo       # updated in place
    for got, want in ((got_x, want_x), (got_p, want_p)):
        assert torch.equal(got.hi, want.hi) and torch.equal(got.lo, want.lo)


@pytest.mark.parametrize("share", [0.0, 1.0])
def test_all_active_and_all_frozen(share):
    jv, tv, active = _inputs(4, 64, frozen_share=share, seed=7)
    x2, p2 = csu.fused_shift_update_df_plain(*tv)
    if share == 1.0:
        assert not active.any()
        for got, src in ((x2, tv[0]), (p2, tv[1])):
            assert torch.equal(got.hi, src.hi) and torch.equal(got.lo,
                                                                src.lo)
    else:
        xx, xp = _xla_reference(*jv[:5], tuple(jv[5:]), jnp.asarray(active))
        np.testing.assert_allclose(_f64(p2), jp.df_to_f64(xp), rtol=1e-13,
                                   atol=1e-13)
        assert not torch.equal(x2.hi, tv[0].hi)
