"""Port vs JAX package: double-float (DF) arithmetic (ops/precision.py).

The port computes the error-free transformations directly on float32
tensors; the JAX package's CPU path computes them through float64 (x64,
which tests/conftest.py enables). Inputs are seeded NumPy arrays handed
to both. Tolerances: two_sum and two_prod exact (hi + lo in float64
equals the float64 result, and both packages give the same pairs);
df_add / df_mul / df_div / df_fma within 1e-13 relative of the JAX
result (JAX's own bar, tests/test_precision.py); df_sum and df_dot
within 1e-12 sum |terms|; df_from_f64 / df_to_f64 round trip within
4e-15.
"""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.ops.precision as jp
import mpi_bicgstab_tpu_torch.ops.precision as tp

torch.set_num_threads(1)


def _f32(rng, n, scale=1.0):
    """float32 values with exponents spread over +-2^29 (no underflow)."""
    return (rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n))
            * scale).astype(np.float32)


def _pair(seed, n=4096):
    rng = np.random.default_rng(seed)
    a64 = rng.standard_normal(n) * np.exp(rng.uniform(-5, 5, n))
    b64 = rng.standard_normal(n) * np.exp(rng.uniform(-5, 5, n))
    return a64, b64


def _t(df):
    return tp.df_to_f64(df)


def _j(df):
    return jp.df_to_f64(df)


@pytest.mark.parametrize("scale", [1.0, 1e-12, 1e12])
def test_two_sum_exact_and_equal_to_jax(scale):
    rng = np.random.default_rng(1)
    a, b = _f32(rng, 8192, scale), _f32(rng, 8192)
    s, e = tp.two_sum(torch.from_numpy(a), torch.from_numpy(b))
    exact = a.astype(np.float64) + b.astype(np.float64)
    got = s.numpy().astype(np.float64) + e.numpy().astype(np.float64)
    np.testing.assert_array_equal(got, exact)
    # the JAX CPU path sums in float64, exact while the exponents differ
    # by at most 29: there the two packages give the same pairs
    ok = np.abs(np.log2(np.abs(a) + 1e-300) - np.log2(np.abs(b) + 1e-300)
                ) < 28
    js, je = jp.two_sum(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(s.numpy()[ok], np.asarray(js)[ok])
    np.testing.assert_array_equal(e.numpy()[ok], np.asarray(je)[ok])
    assert ok.sum() > 1000


@pytest.mark.parametrize("scale", [1.0, 1e-6, 1e6])
def test_two_prod_exact_and_equal_to_jax(scale):
    rng = np.random.default_rng(2)
    a, b = _f32(rng, 8192, scale), _f32(rng, 8192)
    p, e = tp.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    exact = a.astype(np.float64) * b.astype(np.float64)
    got = p.numpy().astype(np.float64) + e.numpy().astype(np.float64)
    np.testing.assert_array_equal(got, exact)
    jpp, je = jp.two_prod(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jpp))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))


def test_quick_two_sum_exact():
    rng = np.random.default_rng(3)
    a = _f32(rng, 8192)
    b = (a * rng.uniform(-1, 1, a.size).astype(np.float32)).astype(
        np.float32)                                    # |b| <= |a|
    s, e = tp.quick_two_sum(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(
        s.numpy().astype(np.float64) + e.numpy().astype(np.float64),
        a.astype(np.float64) + b.astype(np.float64))


@pytest.mark.parametrize("op", ["add", "mul", "div", "fma"])
def test_df_arithmetic_matches_jax(op):
    a64, b64 = _pair(4)
    y64 = np.random.default_rng(5).standard_normal(a64.size)
    ta, tb, ty = (tp.df_from_f64(v) for v in (a64, b64, y64))
    ja, jb, jy = (jp.df_from_f64(v) for v in (a64, b64, y64))
    if op == "fma":
        got, want = _t(tp.df_fma(ty, ta, tb)), _j(jp.df_fma(jy, ja, jb))
        scale = np.abs(y64) + np.abs(a64 * b64)
    else:
        got = _t(getattr(tp, "df_" + op)(ta, tb))
        want = _j(getattr(jp, "df_" + op)(ja, jb))
        # add: relative to the largest |a + b|, JAX's bar; mul and div
        # elementwise relative
        scale = (np.full(a64.size, np.abs(want).max()) if op == "add"
                 else np.abs(want))
    assert np.all(np.abs(got - want) <= 1e-13 * scale)


def test_df_operators_match_the_functions():
    a64, b64 = _pair(6, 512)
    a, b = tp.df_from_f64(a64), tp.df_from_f64(b64)
    np.testing.assert_array_equal(_t(a + b), _t(tp.df_add(a, b)))
    np.testing.assert_array_equal(_t(a - b),
                                  _t(tp.df_add(a, tp.df_neg(b))))
    np.testing.assert_array_equal(_t(a * b), _t(tp.df_mul(a, b)))
    np.testing.assert_array_equal(_t(a / b), _t(tp.df_div(a, b)))
    np.testing.assert_array_equal(_t(-a), -_t(a))
    # mixed operands: Python numbers and float32 tensors on either side
    np.testing.assert_allclose(_t(2.0 * a - 1.0), 2 * _t(a) - 1, rtol=0,
                               atol=1e-13 * np.abs(a64).max())
    np.testing.assert_allclose(_t(1.0 / b), 1 / _t(b), rtol=1e-13)
    np.testing.assert_allclose(_t(a.hi * b), a.hi.double().numpy() * _t(b),
                               rtol=1e-13)
    # comparisons on the normalised difference
    assert torch.equal(a > b, torch.from_numpy(_t(a) > _t(b)))
    assert torch.equal(a <= b, torch.from_numpy(_t(a) <= _t(b)))
    assert bool((a == a).all()) and not bool((a != a).any())


def test_df_container_protocol():
    v = tp.df_from_f64(np.arange(5.0) / 3.0)
    assert v.dtype == torch.float32 and v.shape == (5,) and v.ndim == 1
    assert v.device.type == "cpu" and len(v) == 5
    parts = list(v)
    assert len(parts) == 5 and parts[2].shape == ()
    assert float(parts[2]) == tp.df_to_f64(v)[2]
    assert abs(float(parts[2]) - 2.0 / 3.0) < 1e-15
    assert _t(v[1:3]).tolist() == _t(v)[1:3].tolist()
    w = v.to("cpu")
    assert torch.equal(w.hi, v.hi) and torch.equal(w.lo, v.lo)
    a, b = tp.df_stack([parts[0], parts[4]])
    assert float(a) == float(parts[0]) and float(b) == float(parts[4])


def test_generic_helpers():
    t = torch.arange(4.0)
    d = tp.df_from_f64(np.arange(4.0) / 7.0)
    assert torch.equal(tp.vfma(t, 2.0, t), 3 * t)
    np.testing.assert_allclose(_t(tp.vfma(d, 2.0, d)), 3 * _t(d),
                               rtol=1e-14)
    assert torch.equal(tp.vvalue(t), t)
    assert torch.equal(tp.vvalue(d), d.hi + d.lo)
    pred = torch.tensor([True, False, True, False])
    got = tp.vwhere(pred, d, 0.0)
    np.testing.assert_array_equal(_t(got), np.where(pred.numpy(), _t(d), 0))
    assert torch.equal(tp.vwhere(pred, t, -t), torch.where(pred, t, -t))
    z, o = tp.vzeros((3,), d), tp.vones((), d)
    assert tp.is_df(z) and not z.hi.any() and not z.lo.any()
    assert float(o) == 1.0 and tp.is_df(o)
    assert tp.vzeros((2,), t).dtype == torch.float32
    assert tp.vones((), t.double()).dtype == torch.float64
    assert tp.is_df(tp.vzeros_like(d)) and tp.vzeros_like(d).shape == (4,)


@pytest.mark.parametrize("n", [1, 7, 1001, 4096])
def test_df_sum_and_dot_match_jax(n):
    a64, b64 = _pair(7 + n, n)
    ta, tb = tp.df_from_f64(a64), tp.df_from_f64(b64)
    ja, jb = jp.df_from_f64(a64), jp.df_from_f64(b64)
    got, want = float(_t(tp.df_sum(ta))), float(_j(jp.df_sum(ja)))
    assert abs(got - want) <= 1e-12 * max(np.abs(a64).sum(), 1e-300)
    got, want = float(_t(tp.df_dot(ta, tb))), float(_j(jp.df_dot(ja, jb)))
    assert abs(got - want) <= 1e-12 * np.abs(a64 * b64).sum()
    # float32 inputs: exact products, compensated sum (Dot2)
    a32, b32 = ta.hi, tb.hi
    ref = a32.double().numpy() @ b32.double().numpy()
    got = float(_t(tp.df_dot(a32, b32)))
    assert abs(got - ref) <= 1e-12 * float(
        (a32.double() * b32.double()).abs().sum())


def test_df_sum_along_an_axis():
    m = np.random.default_rng(8).standard_normal((5, 33))
    got = _t(tp.df_sum(tp.df_from_f64(m), axis=-1))
    np.testing.assert_allclose(got, m.sum(-1), rtol=0, atol=1e-13)
    got = _t(tp.df_sum(tp.df_from_f64(m), axis=0))
    np.testing.assert_allclose(got, m.sum(0), rtol=0, atol=1e-13)


def test_roundtrip_and_split_equal_jax():
    a64 = np.random.default_rng(9).standard_normal(1000)
    t = tp.df_from_f64(a64)
    assert np.abs(tp.df_to_f64(t) - a64).max() < 4e-15
    j = jp.df_from_f64(a64)
    np.testing.assert_array_equal(t.hi.numpy(), np.asarray(j.hi))
    np.testing.assert_array_equal(t.lo.numpy(), np.asarray(j.lo))
    s = tp.df_from_f64(np.float64(0.1))           # 0-d stays 0-d
    assert s.shape == () and abs(float(s) - 0.1) < 4e-15 * 0.1


def test_df_renorm_and_where():
    h = torch.tensor([1.0, 3.0], dtype=torch.float32)
    lo = torch.tensor([0.75, -1.0], dtype=torch.float32)
    r = tp.df_renorm(tp.DF(h, lo))
    np.testing.assert_array_equal(_t(r), [1.75, 2.0])
    assert torch.equal(r.hi, r.hi + r.lo)          # normalised


def test_precision_module_calls_no_fused_op():
    """The EFTs stay exact only while no operation is fused into an FMA
    (module docstring): the module calls no addcmul, addcdiv or lerp and
    passes no alpha= argument."""
    tree = ast.parse(Path(tp.__file__).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = getattr(node.func, "attr", getattr(node.func, "id", ""))
            assert name not in ("addcmul", "addcdiv", "lerp"), name
            assert "alpha" not in [k.arg for k in node.keywords]
