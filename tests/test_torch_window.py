"""Port vs JAX package: the windowed-ELL layout (ops/window_ell.py), its
SpMV (ops/window_spmv.py: on the CPU the kernels' plain twins over the
row-compacted copy), the 'auto' route to it, and solves on it.

Layouts: every array and static field equal to JAX's (np.array_equal).
SpMV: the port against JAX's Pallas kernels run as JAX's own tests run
them on the CPU, window_spmv(..., interpret=True), within 1e-5 of the
largest entry in float32, 1e-12 relative in float64 and 1e-13 relative in
double-float (JAX computes DF through float64 on the CPU; the port's DF
EFTs are exact in float32; the float32 tail's level-by-level sums round
differently from JAX's one flat segment sum). The JAX kernels run with one
row tile per grid step (`_TB` set to 1 for each test): every tile's
arithmetic is the same at any grid blocking, and a 16-tile step makes the
interpret-mode trace of each call take 8-40 s. Solves: n_iter within +-2
of JAX's solve on the same layout, and at float64 the residual history
within rtol 1e-6 over the common prefix.

The row-compacted copy (port only): its structure against the CSR and
the slab arrays, and its SpMV bit-equal (float32, float64, DF hi and lo)
to the padded slabs plus the leveled tail, the JAX kernel's order, for
finite x (zeros and -0 included); where x holds an inf at a column that
only padded slots read, the compacted SpMV keeps the row finite.
"""
import dataclasses
import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.api as japi
import mpi_bicgstab_tpu.cli as jcli
import mpi_bicgstab_tpu.models.generators as jgen
import mpi_bicgstab_tpu.models.problem as jprob
import mpi_bicgstab_tpu.ops.layout as jlayout
import mpi_bicgstab_tpu.ops.pallas_window_spmv as jpws
import mpi_bicgstab_tpu.ops.sparse as jsparse
import mpi_bicgstab_tpu.ops.window_ell as jwin
import mpi_bicgstab_tpu_torch.api as tapi
import mpi_bicgstab_tpu_torch.models.generators as tgen
import mpi_bicgstab_tpu_torch.models.problem as tprob
import mpi_bicgstab_tpu_torch.ops.layout as tlayout
import mpi_bicgstab_tpu_torch.ops.sparse as tsparse
import mpi_bicgstab_tpu_torch.ops.window_ell as twin
import mpi_bicgstab_tpu_torch.ops.window_spmv as twsp
from mpi_bicgstab_tpu.io.mmio import write_matrix_market
from mpi_bicgstab_tpu.ops.precision import df_from_f64 as jdf
from mpi_bicgstab_tpu.ops.precision import df_to_f64 as jdf_to_f64
from mpi_bicgstab_tpu.utils.config import SolverConfig as JCfg
from mpi_bicgstab_tpu_torch import cli, convert
from mpi_bicgstab_tpu_torch.ops.precision import (df_from_f64, df_to_f64,
                                                  is_df)
from mpi_bicgstab_tpu_torch.utils.config import SolverConfig

torch.set_num_threads(1)
KEYS = ("sub_sel", "lane_idx", "vals", "window_base", "tail_rows",
        "tail_cols", "tail_vals")
STATIC = ("n_rows", "n_cols", "width", "x_rows", "tail_counts")


@pytest.fixture(autouse=True)
def _one_tile_per_grid_step(monkeypatch):
    monkeypatch.setattr(jpws, "_TB", 1)


def _both(name, *args, **kw):
    """The same generator called in each package: (port CSR, JAX CSR)."""
    t, j = getattr(tgen, name)(*args, **kw), getattr(jgen, name)(*args, **kw)
    for k in ("ptr", "col", "val"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
    return t, j


def _small(seed=3, global_frac=0.02, n=2048, nnz_per_row=3):
    """A narrow clustered matrix (3 nonzeros per row: W ~ 10) whose
    long-range entries fill a tail level."""
    return _both("clustered_random", n, nnz_per_row=nnz_per_row, seed=seed,
                 global_frac=global_frac)


def _host(v):
    """(hi, lo) or the one array of a port value, as NumPy."""
    return (v.hi.numpy(), v.lo.numpy()) if is_df(v) else (v.numpy(),)


def _jhost(v):
    return ((np.asarray(v.hi), np.asarray(v.lo)) if hasattr(v, "hi")
            else (np.asarray(v),))


def _jax_arrays(Aj):
    """A JAX WindowEllMatrix as convert's arrays and meta."""
    arrays = {}
    for k in KEYS:
        v = getattr(Aj, k)
        if hasattr(v, "hi"):
            arrays[k + "_hi"], arrays[k + "_lo"] = _jhost(v)
        else:
            arrays[k] = np.asarray(v)
    return arrays, {k: getattr(Aj, k) for k in STATIC}


def _assert_same_layout(At, Aj):
    for k in KEYS:
        for a, b in zip(_host(getattr(At, k)), _jhost(getattr(Aj, k)),
                        strict=True):
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    for k in STATIC:
        assert getattr(At, k) == getattr(Aj, k), k


def _spill_case():
    """max_width 4 and every tile's window forced onto its neighbour's
    columns: most entries spill, over 8 tail levels."""
    t, j = _both("clustered_random", 2048, seed=5, global_frac=0.05)
    kw = dict(max_width=4, window_base=np.array([1, 0]), force_width=6,
              force_x_rows=24)
    return t, j, kw


LAYOUT_CASES = {
    "clustered4096_f64": lambda: (*_both("clustered_random", 4096), {}),
    "clustered8192_f32": lambda: (
        *_both("clustered_random", 8192, seed=1),
        {"dtype": ("float32", np.float32)}),
    "clustered4096_df32": lambda: (
        *_both("clustered_random", 4096, seed=2, global_frac=0.05),
        {"dtype": ("df32", "df32")}),
    "spill": _spill_case,
}


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_layout_arrays_equal_jax(case):
    t, j, kw = LAYOUT_CASES[case]()
    tdt, jdt = kw.pop("dtype", (None, None))
    At = twin.csr_to_window_ell(t, dtype=tdt and getattr(torch, tdt, tdt),
                                device="cpu", **kw)
    Aj = jwin.csr_to_window_ell(j, dtype=jdt, **kw)
    _assert_same_layout(At, Aj)
    # (JAX's nnz_stored reads vals.size, which a DF pair lacks)
    assert At.tail_size == Aj.tail_size
    assert At.nnz_stored == _jhost(Aj.vals)[0].size + Aj.tail_size
    assert twin.window_ell_stats(t) == jwin.window_ell_stats(j)
    if case == "spill":
        assert len(At.tail_counts) >= 8


def _hub_matrices():
    """tests/test_window_ell.py's hub-row matrix, in each package: one row
    with 100 entries spread over every window."""
    out = []
    for gen, sparse in ((tgen, tsparse), (jgen, jsparse)):
        csr = gen.clustered_random(2048, seed=3, global_frac=0.0)
        rows = np.repeat(np.arange(csr.nrows), np.diff(csr.ptr))
        out.append(sparse.coo_to_csr(sparse.COOMatrix(
            np.concatenate([rows, np.full(100, 7, dtype=np.int64)]),
            np.concatenate([csr.col, np.arange(0, 2000, 20,
                                               dtype=np.int64)]),
            np.concatenate([csr.val, np.full(100, 0.01)]), csr.shape),
            sum_duplicates=True))
    return out


def test_hub_row_refused_by_both_builds():
    """Too deep a tail refuses the layout in both packages; 'auto' then
    tries the butterfly layout, whose build refuses the 100-entry row
    too, and lands on gather-ELL in both packages."""
    t, j = _hub_matrices()
    with pytest.raises(ValueError, match="tail entries"):
        twin.csr_to_window_ell(t, device="cpu")
    with pytest.raises(ValueError, match="tail entries"):
        jwin.csr_to_window_ell(j)
    assert twin.window_ell_stats(t)["window_frac"] >= 0.95
    assert type(jlayout.build_operator(j, cache_dir="off")).__name__ \
        == type(tlayout.build_operator(t, device="cpu")).__name__ \
        == "EllMatrix"


def test_cli_hub_row_falls_through_to_the_butterfly_refusal(tmp_path):
    """The CLI routes the hub-row matrix to windowed-ELL, whose build
    refuses it: 'auto' then falls through the butterfly layout, whose
    build refuses it too, to gather-ELL, where the JAX CLI lands (its
    build_problem on the 1024-padded matrix), and solves it; --format
    window raises the build's own error. (JAX's solve on this gather-ELL
    layout takes ~5 s on the CPU; the ELL SpMV itself is held to JAX's in
    tests/test_torch_layout.py.)"""
    t, j = _hub_matrices()
    assert tlayout.auto_route(t)[0] == "window"
    mtx = _write_mtx(tmp_path / "hub.mtx", t)
    pj = jprob.build_problem(j, multiple=1024)      # as the JAX CLI builds
    assert type(pj.A).__name__ == "EllMatrix"
    got, res = cli.run_solve(cli.build_parser().parse_args(
        ["solve", "--matrix", mtx, "--tol", "1e-10", "--device", "cpu"]))
    assert got["layout"] == "EllMatrix" and got["n"] == 2048
    assert got["converged"] and float((res.x - 1.0).abs().max()) < 1e-7
    with pytest.raises(ValueError, match="tail entries"):
        cli.main(["solve", "--matrix", mtx, "--format", "window",
                  "--device", "cpu"])


def _spmv_pair(At, Aj, x):
    """(port y, JAX y) as float64 NumPy for x, in the layout's dtype."""
    if is_df(At.vals):
        yt = df_to_f64(tlayout.spmv(At, df_from_f64(x)))
        yj = jdf_to_f64(jpws.window_spmv_df(Aj, jdf(x), interpret=True))
        return yt, yj
    dt = At.vals.dtype
    yt = tlayout.spmv(At, torch.as_tensor(x, dtype=dt)).double().numpy()
    yj = jpws.window_spmv(Aj, jnp.asarray(x, np.dtype(str(dt)[6:])),
                          interpret=True)
    return yt, np.asarray(yj, np.float64)


TOL = {"float32": 1e-5, "float64": 1e-12, "df32": 1e-13}


@pytest.mark.parametrize("dtype", ["float32", "float64", "df32"])
@pytest.mark.parametrize("tail", ["tail", "empty_tail", "beyond_n_cols"])
def test_window_spmv_matches_jax_kernel(dtype, tail):
    """'beyond_n_cols': tile 0's window forced onto columns 2048-3071 of a
    2048-column matrix, so its padded slots point past the last column
    (JAX reads its zero-padded x there, the port reads nothing) and its
    entries all go to the tail."""
    kw = {}
    if tail == "tail":
        t, j = _small()
    elif tail == "empty_tail":
        t, j = _small(seed=4, global_frac=0.0, n=1024)
    else:
        t, j = _small(seed=9, nnz_per_row=2)
        kw = dict(window_base=np.array([2, 1]), force_x_rows=24)
    jdt = "df32" if dtype == "df32" else np.dtype(dtype)
    At = twin.csr_to_window_ell(t, dtype=getattr(torch, dtype, dtype),
                                device="cpu", **kw)
    Aj = jwin.csr_to_window_ell(j, dtype=jdt, **kw)
    assert (At.tail_size > 0) == (tail != "empty_tail")
    x = np.random.default_rng(11).standard_normal(t.nrows)
    yt, yj = _spmv_pair(At, Aj, x)
    scale = np.abs(yj).max()
    assert np.abs(yt - yj).max() <= TOL[dtype] * scale
    # both hold the CSR's product (float64: the host oracle to rounding)
    if dtype == "float64":
        np.testing.assert_allclose(yt, t.matvec(x), rtol=0,
                                   atol=1e-13 * scale)


def _stored_zero():
    """_small's matrix with every 97th value stored as 0 and every 101st
    as -0 (kept in the CSR): zero slab entries are not held, zero tail
    entries are."""
    t, _ = _small(seed=3)
    val = t.val.copy()
    val[::97] = 0.0
    val[50::101] = -0.0
    return dataclasses.replace(t, val=val), {}


COMPACT_CASES = {
    "tail": lambda: (_small()[0], {}),
    "empty_tail": lambda: (_small(seed=4, global_frac=0.0, n=1024)[0], {}),
    "beyond_n_cols": lambda: (_small(seed=9, nnz_per_row=2)[0],
                              dict(window_base=np.array([2, 1]),
                                   force_x_rows=24)),
    "deep_tail": lambda: (lambda t, _, kw: (t, kw))(*_spill_case()),
    "stored_zero": _stored_zero,
}


def _compact_case(case, dtype):
    t, kw = COMPACT_CASES[case]()
    A = twin.csr_to_window_ell(t, dtype=getattr(torch, dtype, dtype),
                               device="cpu", **kw)
    return t, A


def _x_with_zeros(n, seed=11):
    x = np.random.default_rng(seed).standard_normal(n)
    x[::7] = 0.0
    x[3::11] = -0.0
    return x


def _put(x, dtype):
    return (df_from_f64(x) if dtype == "df32"
            else torch.as_tensor(x, dtype=getattr(torch, dtype)))


def _bits(v):
    """The bit patterns of a port value (hi and lo of a DF pair)."""
    return [a.view(np.int32 if a.dtype == np.float32 else np.int64)
            for a in _host(v)]


@pytest.mark.parametrize("dtype", ["float32", "float64", "df32"])
@pytest.mark.parametrize("case", sorted(COMPACT_CASES))
def test_compacted_spmv_bit_equal_to_padded_slabs_and_tail(case, dtype):
    """window_spmv (the twin over the compacted copy) against the padded
    slabs plus the leveled tail, bit for bit on finite x."""
    t, A = _compact_case(case, dtype)
    if case == "deep_tail":
        assert len(A.tail_counts) >= 8
    assert (A.tail_size > 0) == (case != "empty_tail")
    x = _put(_x_with_zeros(t.shape[1]), dtype)
    got, want = tlayout.spmv(A, x), twsp.window_padded_plain(A, x)
    for a, b in zip(_bits(got), _bits(want), strict=True):
        np.testing.assert_array_equal(a, b)


def _row_lists(A):
    """Each row's list in the compacted copy, [(col, val), ...] by
    position, read slot by slot from rc_off / rc_col / rc_val (float64
    values; a DF pair summed exactly), and each slice's width."""
    off = A.rc_off.numpy()
    col = A.rc_col.numpy()
    val = (A.rc_val.hi.double() + A.rc_val.lo.double() if is_df(A.rc_val)
           else A.rc_val.double()).numpy()
    lists, widths = [], []
    for s in range(A.n_rows // twin.SLICE_ROWS):
        width, rem = divmod(int(off[s + 1] - off[s]), twin.SLICE_ROWS)
        assert rem == 0
        widths.append(width)
        for lane in range(twin.SLICE_ROWS):
            p = off[s] + lane + twin.SLICE_ROWS * np.arange(width)
            lists.append(list(zip(col[p].tolist(), val[p].tolist())))
    return lists, widths


@pytest.mark.parametrize("case", sorted(COMPACT_CASES))
def test_compacted_copy_structure(case):
    """Each row's list: its nonzero slab entries in slab order, then its
    tail entries in level order, then -1 slots (value 0) to its slice's
    width; each slice as wide as its longest row; the held entries are
    the CSR's entries less the zero-valued slab entries."""
    t, A = _compact_case(case, "float64")
    lists, widths = _row_lists(A)
    n, W = A.n_rows, A.width
    slab_col = np.stack([twin.slab_columns(A, w).reshape(n).numpy()
                         for w in range(W)])
    slab_val = A.vals.reshape(W, n).numpy()
    tail = {}
    for d, c in enumerate(A.tail_counts):
        for r, cc, v in zip(A.tail_rows[d, :c].tolist(),
                            A.tail_cols[d, :c].tolist(),
                            A.tail_vals[d, :c].tolist()):
            tail.setdefault(r, []).append((cc, v))
    held = []
    for r in range(n):
        want = [(int(slab_col[w, r]), float(slab_val[w, r]))
                for w in range(W) if slab_val[w, r] != 0]
        want += tail.get(r, [])
        got = lists[r]
        k = len(want)
        assert got[:k] == want, r
        assert all(cv == (-1, 0.0) for cv in got[k:]), r
        held += [(r, cc, v) for cc, v in want]
    for s, width in enumerate(widths):
        rows = range(s * twin.SLICE_ROWS, (s + 1) * twin.SLICE_ROWS)
        assert width == max(sum(c >= 0 for c, _ in lists[r]) for r in rows)
    assert A.rc_width == max(widths)
    rows = np.repeat(np.arange(t.nrows), np.diff(t.ptr))
    csr = sorted(zip(rows.tolist(), t.col.tolist(), t.val.tolist()))
    tail_zeros = sorted((r, cc, v) for r, lst in tail.items()
                        for cc, v in lst if v == 0)
    nonzero = [e for e in csr if e[2] != 0]
    assert sorted(held) == sorted(nonzero + tail_zeros)
    assert A.nnz_stored == W * n + A.tail_size


def _same_copy(a, b):
    for k in ("rc_off", "rc_col", "rc_val"):
        for u, v in zip(_host(getattr(a, k)), _host(getattr(b, k)),
                        strict=True):
            assert u.dtype == v.dtype, k
            np.testing.assert_array_equal(u, v, err_msg=k)
    assert a.rc_width == b.rc_width


def test_compacted_copy_survives_every_construction():
    """window_ell_with_values, dataclasses.replace and convert (a
    JAX-built layout) all carry the copy of the layout they build."""
    t, j = _small(seed=6)
    host = twin.csr_to_window_ell(t, device="cpu")
    for dtype in (torch.float32, torch.float64, "df32"):
        _same_copy(twin.window_ell_with_values(host, dtype, device="cpu"),
                   twin.csr_to_window_ell(t, dtype=dtype, device="cpu"))
    halved = dataclasses.replace(host, vals=host.vals / 2,
                                 tail_vals=host.tail_vals / 2)
    np.testing.assert_array_equal(halved.rc_val.numpy(),
                                  host.rc_val.numpy() / 2)
    np.testing.assert_array_equal(halved.rc_col.numpy(),
                                  host.rc_col.numpy())
    with pytest.raises(ValueError):
        dataclasses.replace(host, rc_col=host.rc_col)
    arrays, meta = _jax_arrays(jwin.csr_to_window_ell(j, dtype="df32"))
    _same_copy(convert.operator_from_arrays("window", arrays, meta,
                                            device="cpu"),
               twin.csr_to_window_ell(t, dtype="df32", device="cpu"))


@pytest.mark.parametrize("dtype", ["float32", "float64", "df32"])
def test_compacted_spmv_nonfinite_contract(dtype):
    """An inf in x at a column that only padded slots of a row read: the
    padded order gives that row NaN (0 * inf), the compacted SpMV keeps
    it finite. An inf at a held entry's column still reaches its rows."""
    t, A = _compact_case("tail", dtype)
    n = A.n_rows
    rows = np.repeat(np.arange(t.nrows), np.diff(t.ptr))
    slab_col = np.stack([twin.slab_columns(A, w).reshape(n).numpy()
                         for w in range(A.width)])
    vals = A.vals.hi if is_df(A.vals) else A.vals
    pad = (vals.reshape(A.width, n).numpy() == 0) & (slab_col < t.shape[1])
    # a column that a padded slot of row r reads and no entry of r holds
    holds = set(zip(rows.tolist(), t.col.tolist()))
    w, r = next((w, r) for w, r in zip(*np.nonzero(pad))
                if (r, slab_col[w, r]) not in holds)
    c = int(slab_col[w, r])
    x = np.random.default_rng(4).standard_normal(t.shape[1])
    x[c] = np.inf
    y = _host(tlayout.spmv(A, _put(x, dtype)))[0]
    y_pad = _host(twsp.window_padded_plain(A, _put(x, dtype)))[0]
    readers = np.zeros(n, dtype=bool)
    readers[rows[t.col == c]] = True
    assert np.isnan(y_pad[r]) and np.isfinite(y[r])
    np.testing.assert_array_equal(~np.isfinite(y), readers)
    # a held entry's inf: exactly the rows holding that column
    c2 = int(t.col[rows == r][0])
    x = np.random.default_rng(4).standard_normal(t.shape[1])
    x[c2] = np.inf
    y = _host(tlayout.spmv(A, _put(x, dtype)))[0]
    readers = np.zeros(n, dtype=bool)
    readers[rows[t.col == c2]] = True
    assert readers[r] and readers.sum() >= 1
    np.testing.assert_array_equal(~np.isfinite(y), readers)


@pytest.mark.parametrize("dtype", ["float64", "df32"])
def test_layout_carried_across_by_convert(dtype):
    """A JAX-built layout through convert.operator_from_arrays('window')
    multiplies as the port's own build of the same CSR (bit for bit) and
    as JAX's kernel; a tail without its per-level counts (as the JAX
    package's distributed shards carry it) is refused."""
    t, j = _small(seed=6)
    jdt = "df32" if dtype == "df32" else np.float64
    Aj = jwin.csr_to_window_ell(j, dtype=jdt)
    arrays, meta = _jax_arrays(Aj)
    At = convert.operator_from_arrays("window", arrays, meta, device="cpu")
    own = twin.csr_to_window_ell(t, dtype=dtype if dtype == "df32"
                                 else torch.float64, device="cpu")
    _assert_same_layout(At, Aj)
    x = np.random.default_rng(12).standard_normal(t.nrows)
    yt, yj = _spmv_pair(At, Aj, x)
    put = df_from_f64 if dtype == "df32" else torch.as_tensor
    y_own = tlayout.spmv(own, put(x))
    y_conv = tlayout.spmv(At, put(x))
    for a, b in zip(_host(y_conv), _host(y_own), strict=True):
        np.testing.assert_array_equal(a, b)
    assert np.abs(yt - yj).max() <= TOL[dtype] * np.abs(yj).max()
    assert Aj.tail_counts
    with pytest.raises(ValueError, match="tail_counts"):
        convert.operator_from_arrays(
            "window", arrays, {**meta, "tail_counts": ()}, device="cpu")


def _unstructured():
    """Random columns, no window locality (tests/test_torch_layout.py's
    unstructured pair)."""
    rng = np.random.default_rng(6)
    n, k = 2048, 6
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, n * k)
    vals = rng.uniform(-1, 1, n * k)
    return tuple(m.coo_to_csr(m.COOMatrix(rows, cols, vals, (n, n)),
                              sum_duplicates=True)
                 for m in (tsparse, jsparse))


def _hybrid():
    """A band plus 400 random off-band entries (DIA majority)."""
    out = []
    rng = np.random.default_rng(5)
    r, c, v = rng.integers(0, 3072, 400), rng.integers(0, 3072, 400), \
        rng.uniform(-1, 1, 400)
    for gen, sparse in ((tgen, tsparse), (jgen, jsparse)):
        csr = gen.banded_random(3072, [1, -1, 50, -50], seed=4)
        rows = np.repeat(np.arange(csr.nrows), np.diff(csr.ptr))
        out.append(sparse.coo_to_csr(sparse.COOMatrix(
            np.concatenate([rows, r]), np.concatenate([csr.col, c]),
            np.concatenate([csr.val, v]), csr.shape), sum_duplicates=True))
    return tuple(out)


ROUTES = {
    "dia": (lambda: _both("transport_like", 4096, seed=3), "DiaMatrix"),
    "hybrid": (_hybrid, "HybridMatrix"),
    "window": (lambda: _both("clustered_random", 4096, seed=7),
               "WindowEllMatrix"),
    "unstructured": (_unstructured, "ButterflyMatrix"),
}


@pytest.mark.parametrize("kind", sorted(ROUTES))
def test_auto_route_matches_jax(kind):
    """'auto' picks JAX's layout, the butterfly layout included."""
    make, cls = ROUTES[kind]
    t, j = make()
    assert type(jlayout.build_operator(j, cache_dir="off")).__name__ == cls
    assert type(tlayout.build_operator(t, device="cpu")).__name__ == cls
    assert tlayout.auto_route(t)[0] == {"window": "window",
                                        "unstructured": "butterfly"}.get(
                                            kind, "hybrid")


def _jax_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = jcli.main([*argv, "--platform", "cpu", "--json"])
    return code, json.loads(out.getvalue().strip().splitlines()[-1])


def _write_mtx(path, csr):
    rows = np.repeat(np.arange(csr.nrows), np.diff(csr.ptr))
    write_matrix_market(str(path), rows, csr.col, csr.val, csr.shape)
    return str(path)


def test_cli_routes_an_unaligned_clustered_mtx_to_window(tmp_path):
    """The leading 4000 x 4000 block of a clustered_random(4096) (3
    nonzeros per row, so that JAX's interpret-mode kernel traces in
    about a second): n is not a multiple of 1024, so both CLIs route it on
    the matrix padded to 4096 rows, to windowed-ELL, and solve it in
    iterations within 2."""
    _, j = _both("clustered_random", 4096, nnz_per_row=3, seed=8)
    keep = 4000
    rows = np.repeat(np.arange(j.nrows), np.diff(j.ptr))
    m = (rows < keep) & (j.col < keep)
    mtx = tmp_path / "c4000.mtx"
    write_matrix_market(str(mtx), rows[m], j.col[m], j.val[m], (keep, keep))
    base = ["solve", "--matrix", str(mtx), "--tol", "1e-10"]
    jcode, want = _jax_cli(base)
    csr = jsparse.load_csr(str(mtx))
    assert type(jprob.build_problem(csr, multiple=1024).A).__name__ \
        == "WindowEllMatrix"
    got, res = cli.run_solve(cli.build_parser().parse_args(
        [*base, "--device", "cpu"]))
    assert jcode == 0 and want["converged"] and got["converged"]
    assert got["layout"] == "WindowEllMatrix" and got["n"] == keep
    assert res.x.shape == (4096,)
    assert abs(got["total_iter"] - want["total_iter"]) <= 2


# (dtype, method, tol, long-range share) on a 2-nonzeros-a-row matrix
# (W ~ 7): short JAX-side traces; the df32 pipelined case has no tail,
# whose DF ops the JAX solver traces at each SpMV site (covered above)
SOLVES = [("float64", "bicgstab", 1e-10, 0.01),
          ("float32", "bicgstab", 1e-5, 0.01),
          ("df32", "bicgstab", 1e-10, 0.01),
          ("df32", "pipe_bicgstab", 1e-10, 0.0),
          ("float64", "bicgstab_l2", 1e-10, 0.01)]


@pytest.mark.parametrize("dtype,method,tol,global_frac", SOLVES)
def test_solve_on_window_matches_jax(dtype, method, tol, global_frac):
    t, j = _small(global_frac=global_frac, nnz_per_row=2)
    df = dtype == "df32"
    jdt = "df32" if df else getattr(jnp, dtype)
    pj = jprob.build_problem(j, dtype=jdt, format="window")
    rj = japi.solve(pj.A, pj.b, method=method,
                    cfg=JCfg(tol=tol, max_iter=300,
                             dtype=jnp.float32 if df else jdt))
    pt = tprob.build_problem(t, dtype=dtype if df else getattr(torch, dtype),
                             format="window", device="cpu")
    assert type(pt.A).__name__ == type(pj.A).__name__ == "WindowEllMatrix"
    assert (pt.A.tail_size > 0) == (global_frac > 0)
    rt = tapi.solve(pt.A, pt.b, method=method,
                    cfg=SolverConfig(tol=tol, max_iter=300, dtype=dtype))
    assert bool(rt.converged) and bool(rj.converged)
    assert abs(rt.n_iter - int(rj.n_iter)) <= 2
    x = df_to_f64(rt.x) if df else rt.x.double().numpy()
    assert np.abs(x - 1.0).max() < (1e-3 if dtype == "float32" else 1e-7)
    if dtype == "float64":
        k = min(rt.n_iter, int(rj.n_iter))
        np.testing.assert_allclose(rt.history[:k].numpy(),
                                   np.asarray(rj.history)[:k], rtol=1e-6)


@pytest.fixture
def small_mtx(tmp_path):
    t, _ = _small(global_frac=0.01)
    return _write_mtx(tmp_path / "c.mtx", t), t


def test_cli_precond_on_window_matches_jax(small_mtx):
    """`solve --precond cheby:4` routes the window layout through the
    unfused Chebyshev chain over the window SpMV. The JAX CLI takes the
    same preconditioned solve with --format ell: on its window route the
    chain's d + 1 SpMVs per application trace the interpret-mode kernel
    at every call site (~5 s here); the window SpMV itself is held to
    JAX's kernel above."""
    mtx, _ = small_mtx
    base = ["solve", "--matrix", mtx, "--precond", "cheby:4", "--tol",
            "1e-10"]
    jcode, want = _jax_cli([*base, "--format", "ell"])
    got, res = cli.run_solve(cli.build_parser().parse_args(
        [*base, "--device", "cpu"]))
    assert got["layout"] == "WindowEllMatrix"
    assert jcode == 0 and want["converged"] and got["converged"]
    assert got["precond"] == want["precond"]
    assert abs(got["total_iter"] - want["total_iter"]) <= 2
    assert float((res.x - 1.0).abs().max()) < 1e-7


def test_cli_rhs_batch_on_window_matches_jax(small_mtx, tmp_path):
    mtx, t = small_mtx
    B = np.stack([t.matvec(np.ones(t.nrows)),
                  t.matvec(np.random.default_rng(0).standard_normal(
                      t.nrows))])
    np.save(tmp_path / "B.npy", B)
    base = ["solve", "--matrix", mtx, "--rhs-batch",
            str(tmp_path / "B.npy"), "--tol", "1e-10"]
    jcode, want = _jax_cli(base)
    got, res = cli.run_solve(cli.build_parser().parse_args(
        [*base, "--device", "cpu"]))
    assert jcode == 0 and all(want["converged"]) and all(got["converged"])
    assert got["batch"] == 2
    assert all(abs(a - b) <= 2 for a, b in zip(got["n_iter"],
                                               want["n_iter"]))
    assert float((res.x[0] - 1.0).abs().max()) < 1e-7


def test_cli_shifted_on_window_matches_jax(small_mtx):
    mtx, t = small_mtx
    base = ["solve-shifted", "--matrix", mtx, "--format", "window",
            "--sigma-len", "4", "--seed", "1", "--tol", "1e-10"]
    jcode, want = _jax_cli(base)
    rows, res = cli.run_solve_shifted(cli.build_parser().parse_args(
        [*base, "--device", "cpu"]))
    got = rows[0]
    assert jcode == 0 and want["all_converged"] and got["all_converged"]
    assert abs(got["total_iter"] - want["total_iter"]) <= 2
    assert got["final_seed"] == want["final_seed"]
    assert res.x_set.shape == (4, t.nrows)


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_window_ell_with_values_equals_a_build_per_dtype():
    """chip_smoke builds the layout once on the host in float64 and casts
    it: the same arrays as a build in each dtype."""
    t, _ = _small(seed=5)
    host = twin.csr_to_window_ell(t, device="cpu")
    for dtype in (torch.float32, torch.float64, "df32"):
        cast = twin.window_ell_with_values(host, dtype, device="cpu")
        built = twin.csr_to_window_ell(t, dtype=dtype, device="cpu")
        for k in KEYS:
            for a, b in zip(_host(getattr(cast, k)), _host(getattr(built, k)),
                            strict=True):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    with pytest.raises(TypeError):
        twin.window_ell_with_values(cast, torch.float32, device="cpu")


@pytest.mark.parametrize("phase", ["window", "window_f64", "window_df32",
                                   "window_pipe_df32", "reorder"])
def test_chip_smoke_window_and_reorder_phases_on_cpu(phase):
    """chip_smoke's windowed-ELL and reorder phases at a small size on the
    CPU (the twins, no launches): converged, within 2 iterations of
    gather-ELL, the written solution of the reordered solve unpermuted."""
    smoke = _chip_smoke()
    if phase == "reorder":
        counts = smoke.run_reorder_path(8192, device="cpu")
        assert not any(counts.values())
        return
    csr = tgen.clustered_random(8192)
    inp = smoke.window_inputs(csr, device="cpu")
    assert smoke.check_window_spmv(inp) <= 1e-12
    smoke.check_window_padded(inp)
    smoke.check_window_nonfinite(inp)
    probs = smoke.window_problems(inp, device="cpu")
    if phase == "window":
        counts = smoke.run_window_cli(8192, probs["float32"][1], device="cpu")
    else:
        counts = smoke.run_window_api(phase, probs, device="cpu")
    assert not any(counts.values())


def test_chip_smoke_window_launch_rule():
    smoke = _chip_smoke()
    counts = dict.fromkeys(("window_rows", "window_rows_df", "dia_spmv",
                            "fused_body_a", "fused_body_b"), 0)
    check = smoke.check_window_counts
    # classic, 10 iterations in one segment: 2 per iteration + r0 + true
    check("rule", "bicgstab", "float32", 10,
          {**counts, "window_rows": 22}, restarts=2)
    # the same over two segments (one restart)
    check("rule", "bicgstab", "float64", 10,
          {**counts, "window_rows": 24}, restarts=2)
    check("rule", "pipe_bicgstab", "df32", 10,
          {**counts, "window_rows_df": 24, "fused_body_a": 10,
           "fused_body_b": 10}, restarts=2)
    check("rule", "bicgstab", "df32", 10, counts, restarts=2, device="cpu")
    for bad in ({**counts, "window_rows": 23},
                {**counts, "window_rows": 22, "dia_spmv": 1},
                {**counts, "window_rows": 30},
                {**counts, "window_rows_df": 22}):
        with pytest.raises(smoke.SmokeFailure):
            check("rule", "bicgstab", "float32", 10, bad, restarts=2)
    with pytest.raises(smoke.SmokeFailure):
        check("rule", "pipe_bicgstab", "df32", 10,
              {**counts, "window_rows_df": 24}, restarts=2)


def test_chip_smoke_time_routing_on_cpu(capsys):
    """chip_smoke's routing-cost line on a small DIA matrix: the CLI's
    default analyses keep the ordering and route it to DIA/hybrid."""
    smoke = _chip_smoke()
    smoke.time_routing(tgen.transport_like(4096))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert "reorder_auto_host_s" in line and "route_padded_host_s" in line
    with pytest.raises(smoke.SmokeFailure):
        smoke.time_routing(tgen.clustered_random(4096))
