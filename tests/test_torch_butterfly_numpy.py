"""Port vs JAX package: the butterfly's NumPy router (ops/butterfly.py
_route_rounds, _colour_rounds; ops/native_route.py's switch and its
allocation-failure contract) and simulate_numpy.

With the native assigner off on both sides (MBT_NATIVE_ROUTE=0 in the
port; the JAX library dropped as tests/test_butterfly.py drops it), the
same CSR and seed give the same tables bit for bit: the two packages draw
the same random numbers in the same order and resolve the same winners.
simulate_numpy runs the routed pipeline on host copies of the port's
tables and equals the JAX package's bit for bit; against the port's SpMV
(the column table's twin) and the CSR product it agrees within 1e-12
relative in float64, on both routers' layouts. The CLI and the layout
cache see the switch.
"""
import contextlib
import io
import json

import jax  # noqa: F401  (the test files import both packages)
import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.cli as jcli
import mpi_bicgstab_tpu.models.generators as jgen
import mpi_bicgstab_tpu.ops.butterfly as jbf
import mpi_bicgstab_tpu.ops.native_route as jnr
import mpi_bicgstab_tpu.ops.sparse as jsparse
import mpi_bicgstab_tpu_torch.models.generators as tgen
import mpi_bicgstab_tpu_torch.ops.butterfly as tbf
import mpi_bicgstab_tpu_torch.ops.layout as tlayout
import mpi_bicgstab_tpu_torch.ops.sparse as tsparse
from mpi_bicgstab_tpu.ops.precision import DF as JDF
from mpi_bicgstab_tpu_torch import cli
from mpi_bicgstab_tpu_torch.ops import native_route
from mpi_bicgstab_tpu_torch.ops.precision import is_df

torch.set_num_threads(1)
KEYS = ("k1_src", "k1_sub", "k1_lane", "k2_sub", "k2_lane", "k3_sub",
        "k3_lane", "k3_vals", "tail_rows", "tail_cols", "tail_vals")
STATIC = ("rb", "n_rows", "n_cols", "n_pad", "nc_pad", "P", "nnz", "tail_n")
DTYPES = {"float64": (None, None), "float32": (torch.float32, np.float32),
          "df32": ("df32", "df32")}


@pytest.fixture
def numpy_router(monkeypatch):
    """Both packages' native assigners off."""
    monkeypatch.setenv("MBT_NATIVE_ROUTE", "0")
    monkeypatch.setattr(jnr, "_LIB", None)
    monkeypatch.setattr(jnr, "_TRIED", True)


def _both(n, nnz_per_row, seed):
    t = tgen.random_diag_dominant(n, nnz_per_row=nnz_per_row, seed=seed)
    j = jgen.random_diag_dominant(n, nnz_per_row=nnz_per_row, seed=seed)
    np.testing.assert_array_equal(t.val, j.val)
    return t, j


def _slab(t, j, keep):
    """The first `keep` rows of each CSR, all columns: the rectangular
    row slab a partition's shard routes."""
    out = []
    for csr, sparse in ((t, tsparse), (j, jsparse)):
        end = csr.ptr[keep]
        out.append(sparse.CSRMatrix(csr.ptr[: keep + 1], csr.col[:end],
                                    csr.val[:end], (keep, csr.shape[1])))
    return tuple(out)


def _host(v):
    return (v.hi.numpy(), v.lo.numpy()) if is_df(v) else (v.numpy(),)


def _jhost(v):
    return ((np.asarray(v.hi), np.asarray(v.lo)) if hasattr(v, "hi")
            else (np.asarray(v),))


def _assert_same_layout(At, Aj):
    for k in KEYS:
        for a, b in zip(_host(getattr(At, k)), _jhost(getattr(Aj, k)),
                        strict=True):
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    for k in STATIC:
        assert getattr(At, k) == getattr(Aj, k), k


def _build(t, j, dtype="float64", **kw):
    tdt, jdt = DTYPES[dtype]
    return (tbf.build_butterfly(t, dtype=tdt, device="cpu", **kw),
            jbf.build_butterfly(j, dtype=jdt, **kw))


def _natural_P(t) -> int:
    return tbf.butterfly_tables(t)["P"]


CASES = {   # case -> (CSR pair, build keywords)
    "seed3": (lambda: _both(4096, 6, 3), {}),
    "seed5": (lambda: _both(4096, 6, 5), {"seed": 2}),
    # a shard's row slab on the partition's harmonised geometry: rb and
    # a P two window groups above the slab's own
    "forced": (lambda: _slab(*_both(6000, 6, 2), 2500), "forced"),
}


@pytest.mark.usefixtures("numpy_router")
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_numpy_router_tables_equal_jax(case, dtype):
    make, kw = CASES[case]
    t, j = make()
    if kw == "forced":
        kw = {"rb_force": 32, "P_force": _natural_P(t) + 2048}
    At, Aj = _build(t, j, dtype, **kw)
    _assert_same_layout(At, Aj)
    assert At.tail_n > 0
    if case == "forced":
        assert (At.rb, At.P, At.shape) == (32, kw["P_force"], (2500, 6000))


def test_switch_off_never_builds_the_library(monkeypatch):
    """MBT_NATIVE_ROUTE=0 / off: the assigner answers None without
    loading (or building) its library; the switch is read at each call."""
    calls = []
    monkeypatch.setattr(native_route, "library",
                        lambda: calls.append(1) or pytest.fail("built"))
    e = np.zeros(4, np.int64)
    for value in ("0", "off", "OFF"):
        monkeypatch.setenv("MBT_NATIVE_ROUTE", value)
        assert not native_route.native_enabled()
        assert native_route.router() == "numpy"
        assert native_route.assign_native(e, e, e, e, e, e.reshape(4, 1),
                                          e + 1, 1, 4, 1, 1024, 4, 0) is None
        assert native_route.color_native(e, e, e, e, 2048, 16, 3, 1) is None
    monkeypatch.setenv("MBT_NATIVE_ROUTE", "1")
    assert native_route.native_enabled() and native_route.router() == "native"
    assert not calls


@pytest.mark.usefixtures("numpy_router")
def test_one_round_refuses_as_jax_does():
    """rounds=1 leaves most elements unplaced: both packages refuse with
    the same message (or, were the spill small, would build the same
    tables)."""
    t, j = _both(4096, 6, 3)
    errors = []
    for build in (lambda: tbf.build_butterfly(t, rounds=1, device="cpu"),
                  lambda: jbf.build_butterfly(j, rounds=1)):
        with pytest.raises(ValueError) as e:
            build()
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert errors[0].startswith("routing spill")
    At, Aj = _build(t, j, rounds=40)
    _assert_same_layout(At, Aj)


def _wide(gen, sparse):
    """tests/test_butterfly.py's wide-row matrix: row 0 gains 60 entries."""
    n = 2048
    base = gen.random_diag_dominant(n, nnz_per_row=8, seed=1)
    brows = np.repeat(np.arange(n, dtype=np.int64), base.row_lengths)
    rows = np.concatenate([np.zeros(60, np.int64), brows])
    cols = np.concatenate([np.arange(60, dtype=np.int64) * 30 % n, base.col])
    return sparse.coo_to_csr(sparse.COOMatrix(rows, cols, np.ones(rows.size),
                                              (n, n)), sum_duplicates=True)


def _dense_rows(gen, sparse):
    """70 distinct columns spread over the matrix in every row: even a
    16-row block needs more distinct columns than a window holds."""
    n = 4096
    rows = np.repeat(np.arange(n, dtype=np.int64), 70)
    cols = (np.arange(n * 70, dtype=np.int64) * 59 + rows) % n
    return sparse.coo_to_csr(sparse.COOMatrix(
        np.concatenate([rows, np.arange(n)]),
        np.concatenate([cols, np.arange(n)]),
        np.concatenate([np.ones(rows.size), np.full(n, 80.0)]), (n, n)),
        sum_duplicates=True)


@pytest.mark.usefixtures("numpy_router")
@pytest.mark.parametrize("case,kw", [("wide", {}),
                                     ("dense", {"max_width": 128})])
def test_refusals_carry_jax_messages(case, kw):
    """Under the NumPy router both builds refuse the same matrices with
    the same message."""
    make = _wide if case == "wide" else _dense_rows
    t, j = make(tgen, tsparse), make(jgen, jsparse)
    errors = []
    for build in (lambda: tbf.build_butterfly(t, device="cpu", **kw),
                  lambda: jbf.build_butterfly(j, **kw)):
        with pytest.raises(ValueError) as e:
            build()
        errors.append(str(e.value))
    assert errors[0] == errors[1]


class _FullLibrary:
    """A route library whose claim tables cannot be allocated."""

    calls = 0

    def bfly_assign(self, *args):
        _FullLibrary.calls += 1
        return -1

    bfly_color = bfly_assign


def test_allocation_failure_falls_through_to_the_numpy_rounds(monkeypatch):
    """A library that returns -1 (JAX's allocation-failure contract):
    assign_native and color_native answer None and the build takes the
    NumPy rounds: the tables of JAX's NumPy router."""
    t, j = _both(4096, 6, 3)
    monkeypatch.setenv("MBT_NATIVE_ROUTE", "1")
    monkeypatch.setattr(native_route, "library", lambda: _FullLibrary())
    _FullLibrary.calls = 0
    At = tbf.build_butterfly(t, device="cpu")
    assert _FullLibrary.calls >= 2     # the assigner and the colouring
    monkeypatch.setattr(jnr, "_LIB", None)
    monkeypatch.setattr(jnr, "_TRIED", True)
    _assert_same_layout(At, jbf.build_butterfly(j))


@pytest.mark.usefixtures("numpy_router")
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_simulate_numpy_equals_jax_bit_for_bit(dtype):
    t, j = _both(4096, 6, 3)
    At, Aj = _build(t, j, dtype)
    if dtype == "df32":
        assert isinstance(Aj.k3_vals, JDF)
    for seed in (1, 2):
        x = np.random.default_rng(seed).standard_normal(t.nrows)
        yt, yj = tbf.simulate_numpy(At, x), jbf.simulate_numpy(Aj, x)
        assert yt.dtype == yj.dtype and yt.shape == (t.nrows,)
        np.testing.assert_array_equal(yt, yj)


@pytest.mark.parametrize("router", ["numpy", "native"])
def test_simulate_numpy_matches_the_port_spmv(monkeypatch, router):
    """On either router's layout (float64), simulate_numpy, the port's
    SpMV (the column table's twin) and the CSR product agree within
    1e-12 relative; simulate_numpy never reads k3_col."""
    monkeypatch.setenv("MBT_NATIVE_ROUTE", "0" if router == "numpy" else "1")
    t = tgen.random_diag_dominant(4096, nnz_per_row=6, seed=3)
    A = tbf.build_butterfly(t, device="cpu")
    x = np.random.default_rng(4).standard_normal(t.nrows)
    y_sim = tbf.simulate_numpy(A, x)
    y_twin = tlayout.spmv(A, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y_sim, t.matvec(x), rtol=1e-12)
    np.testing.assert_allclose(y_twin, y_sim, rtol=1e-12)
    A.k3_col.fill_(-1)       # the decoded table, spoiled: no effect
    np.testing.assert_array_equal(tbf.simulate_numpy(A, x), y_sim)


def test_numpy_router_spills_more_than_the_native_one(monkeypatch):
    t = tgen.random_diag_dominant(4096, nnz_per_row=6, seed=3)
    tails = {}
    for value in ("1", "0"):
        monkeypatch.setenv("MBT_NATIVE_ROUTE", value)
        tails[value] = tbf.butterfly_tables(t)["tail_n"]
    assert tails["0"] > tails["1"]


def _jax_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = jcli.main([*argv, "--platform", "cpu", "--json"])
    return code, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.usefixtures("numpy_router")
def test_cli_butterfly_solve_under_the_switch_matches_jax():
    """MBT_NATIVE_ROUTE=0 solve --matrix uniform:4096 --format butterfly:
    both CLIs route with NumPy; total_iter within 2, converged equal."""
    base = ["solve", "--matrix", "uniform:4096", "--format", "butterfly"]
    jcode, want = _jax_cli(base)
    got, res = cli.run_solve(cli.build_parser().parse_args(
        [*base, "--device", "cpu"]))
    assert got["layout"] == "ButterflyMatrix"
    assert got["converged"] == want["converged"]
    assert jcode == (0 if want["converged"] else 2)
    assert abs(got["total_iter"] - want["total_iter"]) <= 2
    assert float((res.x - 1.0).abs().max()) < 1e-6


def test_layout_cache_keys_the_router(monkeypatch, tmp_path):
    """The NumPy and the native layout of one CSR are two cache entries,
    each loaded back with its own tail."""
    t = tgen.random_diag_dominant(4096, nnz_per_row=6, seed=3)
    built = {}
    for value in ("0", "1", "0"):
        monkeypatch.setenv("MBT_NATIVE_ROUTE", value)
        A = tlayout.build_operator(t, format="butterfly", device="cpu",
                                   cache_dir=str(tmp_path))
        built.setdefault(value, []).append(A.tail_n)
    assert len(list(tmp_path.glob("*.npz"))) == 2
    assert built["0"][0] == built["0"][1] != built["1"][0]


def test_chip_smoke_butterfly_numpy_phase_on_cpu(tmp_path):
    """chip_smoke's [butterfly_numpy] at a small size on the CPU: the
    NumPy route in its own process under MBT_NATIVE_ROUTE=0 (the tables
    of butterfly_tables under the switch), then the phase's checks (the
    f32 solve within 2 iterations of the native layout's, the SpMVs,
    simulate_numpy); no launch counted."""
    import importlib.util
    from pathlib import Path

    from mpi_bicgstab_tpu_torch.api import solve
    from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    n = 4000
    csr = smoke.uniform_csr(n)
    out = tmp_path / "route.npz"
    host, route_s = smoke.finish_numpy_route(smoke.start_numpy_route(n, out),
                                             out)
    assert route_s > 0 and not out.exists()
    binp = smoke.butterfly_inputs(csr, device="cpu")
    b = torch.as_tensor(csr.matvec(np.ones(csr.nrows)), dtype=torch.float32)
    it = solve(binp["B32"], b, cfg=SolverConfig(tol=smoke.UNIFORM_TOL,
                                                dtype=torch.float32)).n_iter
    counts = smoke.run_butterfly_numpy(binp, host, route_s, it, device="cpu")
    assert not any(counts.values())
    import os
    os.environ["MBT_NATIVE_ROUTE"] = "0"
    try:
        want = tbf.butterfly_tables(csr)
    finally:
        del os.environ["MBT_NATIVE_ROUTE"]
    assert host.tail_n == want["tail_n"] > binp["B32"].tail_n
    np.testing.assert_array_equal(host.k3_lane.numpy(), want["k3_lane"])
