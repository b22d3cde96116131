"""Port vs JAX package: the butterfly layout's column table and the K3
twins that read x through it (ButterflyMatrix.k3_col,
ops/butterfly_spmv.column_table, k3_plain, k3_df_plain).

The JAX pipeline routes x through K1, T1, K2 and T2 on every SpMV; the
port routes the iota 1..n_cols once per layout and keeps, per K3 slot, the
column of x it reads (-1 for K1's zero past the last column). Checks: the
table equals a NumPy composition of JAX's own tables (routed layouts, and
random K1/K2 tables that read column 0 and columns past n_cols); the twins
equal, bit for bit, the routed pipeline's arithmetic on z (chip_smoke's
staged_slabs, which the card's kernels are held to as well) for x with
NaN and inf planted and for an all -0 x (the sign of zero); every
constructor carries the table; an SpMV routes nothing.
"""
import copy
import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.models.generators as jgen
import mpi_bicgstab_tpu.ops.butterfly as jbf
import mpi_bicgstab_tpu.ops.sparse as jsparse
import mpi_bicgstab_tpu_torch.models.generators as tgen
import mpi_bicgstab_tpu_torch.ops.butterfly as tbf
import mpi_bicgstab_tpu_torch.ops.butterfly_spmv as tbs
import mpi_bicgstab_tpu_torch.ops.layout as tlayout
import mpi_bicgstab_tpu_torch.ops.sparse as tsparse
from mpi_bicgstab_tpu_torch import convert
from mpi_bicgstab_tpu_torch.ops import cuda_butterfly as cbf
from mpi_bicgstab_tpu_torch.ops.precision import DF, df_from_f64, is_df

torch.set_num_threads(1)


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()


def _rows(csr, sparse, keep):
    end = csr.ptr[keep]
    return sparse.CSRMatrix(csr.ptr[: keep + 1], csr.col[:end],
                            csr.val[:end], (keep, csr.shape[1]))


# (port CSR, JAX CSR): the same generator in each package; "rect" is a
# 2500-row slab of 6000 columns (nc_pad 6144 > n_cols)
CASES = {
    "4096": lambda g, s: g.random_diag_dominant(4096),
    "20480_rb32": lambda g, s: g.random_diag_dominant(20480, nnz_per_row=12,
                                                      seed=1),
    "rect": lambda g, s: _rows(g.random_diag_dominant(6000, seed=2), s,
                               2500),
}


def np_columns(A) -> np.ndarray:
    """The column each K3 slot reads, composed in NumPy from A's tables
    (JAX's or the port's) as the JAX XLA pipeline routes x: K1 (-1 past
    n_cols, where x is zero-padded), T1, K2, T2, then K3's 'lane' element
    of the stacked windows."""
    t = {k: np.asarray(getattr(A, k)).astype(np.int64) for k in
         ("k1_src", "k1_sub", "k1_lane", "k2_sub", "k2_lane", "k3_sub",
          "k3_lane")}
    P = A.P
    lam = t["k1_lane"]
    u1 = (t["k1_src"][:, None, None] * 1024
          + np.take_along_axis(t["k1_sub"], lam, axis=2) * 128 + lam)
    u1 = np.where(u1 < A.n_cols, u1, -1).reshape(P, 1024)
    mid = u1.T.reshape(P, 1024)
    lam = t["k2_lane"]
    e2 = (np.take_along_axis(t["k2_sub"], lam, axis=2) * 128
          + lam).reshape(P, 1024)
    z = np.take_along_axis(mid, e2, axis=1).T.reshape(-1)
    W, NR = A.width, A.n_pad // 128
    lane = t["k3_lane"].reshape(W, NR, 128)
    s = np.take_along_axis(t["k3_sub"].reshape(W, NR, 128), lane, axis=2)
    blk = np.arange(NR)[:, None] * A.stack + np.arange(128) // A.rb
    elem = ((blk[None] * 8 + (s & 7)) * 128 + lane)
    return z[elem].reshape(W // 8, 8, NR, 128)


@functools.cache
def _port_layout(case, dtype="float64"):
    csr = CASES[case](tgen, tsparse)
    dt = {"float64": None, "float32": torch.float32, "df32": "df32"}[dtype]
    return csr, tbf.build_butterfly(csr, dtype=dt, device="cpu")


def _random_k1_k2(A, seed=5):
    """A with random K1/K2 tables (every source window, its first u1
    windows reading the last one, past column n_cols - 1) and the column
    table routed anew from them."""
    g = np.random.default_rng(seed)

    def rand(hi):
        return torch.as_tensor(g.integers(0, hi, (A.P, 8, 128)).astype(
            np.int8))
    src = g.integers(0, A.nc_pad // 1024, A.P).astype(np.int32)
    src[:64] = A.nc_pad // 1024 - 1
    return dataclasses.replace(
        A, k1_src=torch.as_tensor(src), k1_sub=rand(8), k1_lane=rand(128),
        k2_sub=rand(8), k2_lane=rand(128))


@pytest.mark.parametrize("case", sorted(CASES))
def test_column_table_composes_jax_tables(case):
    """k3_col of the port's build equals the NumPy composition of JAX's
    own tables for the same CSR (column 0 among the entries; the rect
    case has nc_pad > n_cols)."""
    t, j = CASES[case](tgen, tsparse), CASES[case](jgen, jsparse)
    Aj = jbf.build_butterfly(j)
    _, At = _port_layout(case)
    assert At.k3_col.dtype == torch.int32
    assert tuple(At.k3_col.shape) == tuple(At.k3_lane.shape)
    want = np_columns(Aj)
    np.testing.assert_array_equal(At.k3_col.numpy(), want)
    assert (want == 0).any() and want.max() < t.shape[1]
    if case == "rect":
        assert At.nc_pad > At.n_cols == 6000


def test_column_table_marks_k1_zero_with_minus_one():
    """Random K1/K2 tables on the rect case: slots that K1 fills past the
    last column read -1, slots that read column 0 read 0 (only the iota's
    +1 shift tells the two apart), as the NumPy composition says."""
    _, A = _port_layout("rect")
    R = _random_k1_k2(A)
    got = R.k3_col.numpy()
    np.testing.assert_array_equal(got, np_columns(R))
    assert (got == -1).any() and (got == 0).any()
    assert got.max() < R.n_cols


X_KINDS = ("normal", "nan_inf", "neg_zero")


def _x(kind, n, dtype):
    x = np.random.default_rng(8).standard_normal(n)
    if kind == "nan_inf":
        x = SMOKE.planted(x, 9)
    elif kind == "neg_zero":
        x = np.full(n, -0.0)
    if dtype == "df32":
        return df_from_f64(x)
    return torch.as_tensor(x, dtype=getattr(torch, dtype))


@pytest.mark.parametrize("tables", ["routed", "random"])
@pytest.mark.parametrize("kind", X_KINDS)
@pytest.mark.parametrize("dtype", ["float32", "float64", "df32"])
def test_k3_twins_equal_the_routed_pipeline(dtype, kind, tables):
    """k3_plain / k3_df_plain on x through the column table, against K3's
    arithmetic on z = route(A, x) (the routed pipeline, chip_smoke's
    staged_slabs): equal bit for bit, NaN, inf, -1 slots and the sign of
    zero included (rect case: 6000 columns)."""
    _, A = _port_layout("rect", dtype)
    if tables == "random":
        A = _random_k1_k2(A)
    x = _x(kind, A.n_cols, dtype)
    twin = (tbs.k3_df_plain if dtype == "df32" else tbs.k3_plain)(A, x)
    assert SMOKE.same_bits(twin, SMOKE.staged_slabs(A, x))
    y = twin.hi if dtype == "df32" else twin
    if kind == "nan_inf":
        assert y.isnan().any() and not y.isnan().all()
    if kind == "neg_zero":      # -0 products summed from +0: +0
        assert (y == 0).all() and not torch.signbit(y).any()


def test_butterfly_with_values_routes_its_own_table():
    """The cast layout of each dtype carries the table a build in that
    dtype routes, as a table of its own (routed anew, not shared with the
    float64 layout's)."""
    t = tgen.random_diag_dominant(4096, seed=7)
    host = tbf.build_butterfly(t, device="cpu")
    for dtype in (torch.float32, torch.float64, "df32"):
        cast = tbf.butterfly_with_values(host, dtype, device="cpu")
        built = tbf.build_butterfly(t, dtype=dtype, device="cpu")
        assert torch.equal(cast.k3_col, built.k3_col)
        assert torch.equal(cast.k3_col, host.k3_col)
        assert cast.k3_col.data_ptr() != host.k3_col.data_ptr()


@pytest.mark.parametrize("dtype", ["float64", "df32"])
def test_convert_routes_the_column_table(dtype):
    """A layout carried across from JAX's arrays gets its column table,
    equal to the port's own build and to the composition of JAX's
    tables."""
    t, j = CASES["4096"](tgen, tsparse), CASES["4096"](jgen, jsparse)
    Aj = jbf.build_butterfly(j, dtype="df32" if dtype == "df32" else None)
    arrays = {}
    for k in ("k1_src", "k1_sub", "k1_lane", "k2_sub", "k2_lane", "k3_sub",
              "k3_lane", "k3_vals", "tail_rows", "tail_cols", "tail_vals"):
        v = getattr(Aj, k)
        if hasattr(v, "hi"):
            arrays[k + "_hi"], arrays[k + "_lo"] = (np.asarray(v.hi),
                                                    np.asarray(v.lo))
        else:
            arrays[k] = np.asarray(v)
    meta = {k: getattr(Aj, k) for k in ("rb", "n_rows", "n_cols", "n_pad",
                                        "nc_pad", "P", "nnz", "tail_n")}
    At = convert.operator_from_arrays("butterfly", arrays, meta,
                                      device="cpu")
    _, own = _port_layout("4096")
    assert torch.equal(At.k3_col, own.k3_col)
    np.testing.assert_array_equal(At.k3_col.numpy(), np_columns(Aj))
    assert is_df(At.k3_vals) == (dtype == "df32")


@pytest.mark.parametrize("dtype", ["float32", "float64", "df32"])
def test_spmv_routes_nothing(dtype, monkeypatch):
    """An SpMV reads x through the table: K1, K2 and the decode are not
    called (they build the table once per layout), and the result is the
    CSR product."""
    csr, A = _port_layout("4096", dtype)

    def refuse(*args):
        raise AssertionError("routed per SpMV")
    for name in ("k1_plain", "k2_plain", "decode_plain", "route"):
        monkeypatch.setattr(tbs, name, refuse)
    x = np.random.default_rng(3).standard_normal(csr.shape[1])
    xt = df_from_f64(x) if dtype == "df32" else torch.as_tensor(
        x, dtype=getattr(torch, dtype))
    y = tlayout.spmv(A, xt)
    y = (y.hi.double() + y.lo.double()) if is_df(y) else y.double()
    ref = csr.matvec(x)
    tol = 1e-5 if dtype == "float32" else 1e-12
    assert np.abs(y.numpy() - ref).max() <= tol * np.abs(ref).max()


def test_k3_wrappers_take_card_tensors_only():
    """The wrappers never fall back to the twins: CPU tensors and a
    column table of the wrong shape raise."""
    _, A = _port_layout("4096", "float32")
    _, Adf = _port_layout("4096", "df32")
    x = torch.ones(A.n_cols)
    with pytest.raises(ValueError):
        cbf.butterfly_k3(A, x)
    with pytest.raises(ValueError):
        cbf.butterfly_k3_df(Adf, DF(x, x))
    bad = copy.copy(A)
    object.__setattr__(bad, "k3_col", A.k3_col[:1])
    with pytest.raises(ValueError):
        cbf.butterfly_k3(bad, x)
    with pytest.raises(TypeError):
        cbf.butterfly_k3_df(Adf, x)
    with pytest.raises(ValueError):
        cbf.butterfly_k3(A, x[:100])


def test_auto_falls_through_only_on_a_refusal(monkeypatch):
    """'auto' goes on to gather-ELL where the butterfly router refuses a
    matrix (a 100-entry row: LayoutRefused, before the column table is
    built), but an error from the table's build (a kernel's argument
    check on the card) is raised, not taken for a refusal."""
    csr = CASES["4096"](tgen, tsparse)
    rows = np.repeat(np.arange(csr.nrows), np.diff(csr.ptr))
    hub = tsparse.coo_to_csr(tsparse.COOMatrix(
        np.concatenate([rows, np.full(100, 7, dtype=np.int64)]),
        np.concatenate([csr.col, np.arange(0, 4000, 40, dtype=np.int64)]),
        np.concatenate([csr.val, np.full(100, 0.01)]), csr.shape),
        sum_duplicates=True)
    assert type(tlayout.build_operator(csr, device="cpu")).__name__ \
        == "ButterflyMatrix"

    def broken(A):
        raise ValueError("k3_col: a kernel refused its arguments")
    monkeypatch.setattr(tbs, "column_table", broken)
    assert type(tlayout.build_operator(hub, device="cpu")).__name__ \
        == "EllMatrix"
    with pytest.raises(ValueError, match="kernel refused"):
        tlayout.build_operator(csr, device="cpu")
