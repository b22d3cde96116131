"""Port vs JAX package: the butterfly-routed layout (ops/butterfly.py,
ops/native_route.py), its SpMV (ops/butterfly_spmv.py: the kernels' plain
twins, the transposes and the leveled tail), the 'auto' route to it, and
solves on it.

Layouts: every table and static field equal to JAX's (np.array_equal;
both run the same C++ router from the same seed). Stage twins: K1 and K2
equal to JAX's Pallas _k1 / _k2 run in interpret mode (pure data
movement), K3 within 1e-6 (float32) and 1e-12 (float64) of the largest
output entry of JAX's _k3, and the DF K3 within 1e-10 of JAX's _k3_df
(JAX computes DF through float64 on the CPU, and its interpret-mode DF
chains round differently: JAX's own bar for its DF pipeline in interpret
mode, tests/test_butterfly.py). The JAX kernels run on a few windows or
row tiles with their grid blocking patched small (`_tb_windows`,
`_tb_rows`): every window's and row tile's arithmetic is the same at any
blocking, and the whole interpret pipeline takes 40-57 s. Whole SpMV
against JAX's XLA forms: 1e-5 of the largest entry in float32, 1e-12 in
float64, 1e-13 relative in double-float (the port adds the float tail
level by level, JAX in one segment sum). Solves: n_iter within +-2 of
JAX's.
"""
import contextlib
import dataclasses
import io
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.api as japi
import mpi_bicgstab_tpu.cli as jcli
import mpi_bicgstab_tpu.models.generators as jgen
import mpi_bicgstab_tpu.models.problem as jprob
import mpi_bicgstab_tpu.ops.butterfly as jbf
import mpi_bicgstab_tpu.ops.layout as jlayout
import mpi_bicgstab_tpu.ops.pallas_butterfly as jpb
import mpi_bicgstab_tpu.ops.sparse as jsparse
import mpi_bicgstab_tpu_torch.api as tapi
import mpi_bicgstab_tpu_torch.models.generators as tgen
import mpi_bicgstab_tpu_torch.models.problem as tprob
import mpi_bicgstab_tpu_torch.ops.butterfly as tbf
import mpi_bicgstab_tpu_torch.ops.butterfly_spmv as tbs
import mpi_bicgstab_tpu_torch.ops.layout as tlayout
import mpi_bicgstab_tpu_torch.ops.sparse as tsparse
from mpi_bicgstab_tpu.ops.precision import DF as JDF
from mpi_bicgstab_tpu.ops.precision import df_from_f64 as jdf
from mpi_bicgstab_tpu.ops.precision import df_to_f64 as jdf_to_f64
from mpi_bicgstab_tpu.utils.config import SolverConfig as JCfg
from mpi_bicgstab_tpu_torch import cli, convert
from mpi_bicgstab_tpu_torch.ops import native_route
from mpi_bicgstab_tpu_torch.ops.precision import (DF, df_from_f64, df_to_f64,
                                                  is_df)
from mpi_bicgstab_tpu_torch.utils.config import SolverConfig

torch.set_num_threads(1)
KEYS = ("k1_src", "k1_sub", "k1_lane", "k2_sub", "k2_lane", "k3_sub",
        "k3_lane", "k3_vals", "tail_rows", "tail_cols", "tail_vals")
STATIC = ("rb", "n_rows", "n_cols", "n_pad", "nc_pad", "P", "nnz", "tail_n")


def _both(name, *args, **kw):
    """The same generator called in each package: (port CSR, JAX CSR)."""
    t, j = getattr(tgen, name)(*args, **kw), getattr(jgen, name)(*args, **kw)
    for k in ("ptr", "col", "val"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
    return t, j


def _rows(t, j, keep):
    """The first `keep` rows of each CSR (all columns): a rectangular
    row slab, as the JAX package's distributed shards route it."""
    out = []
    for csr, sparse in ((t, tsparse), (j, jsparse)):
        end = csr.ptr[keep]
        out.append(sparse.CSRMatrix(csr.ptr[: keep + 1], csr.col[:end],
                                    csr.val[:end], (keep, csr.shape[1])))
    return tuple(out)


def _host(v):
    """(hi, lo) or the one array of a port value, as NumPy."""
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
    assert (At.G, At.stack, At.width, At.tail_count) == \
        (Aj.G, Aj.stack, Aj.width, Aj.tail_count)
    assert At.shape == Aj.shape


def _jax_arrays(Aj):
    """A JAX ButterflyMatrix as convert's arrays and meta."""
    arrays = {}
    for k in KEYS:
        v = getattr(Aj, k)
        if hasattr(v, "hi"):
            arrays[k + "_hi"], arrays[k + "_lo"] = _jhost(v)
        else:
            arrays[k] = np.asarray(v)
    return arrays, {k: getattr(Aj, k) for k in STATIC}


def test_random_diag_dominant_equals_jax():
    t, _ = _both("random_diag_dominant", 3000, nnz_per_row=6, seed=4)
    assert t.shape == (3000, 3000) and t.nnz > 5 * 3000
    _both("random_diag_dominant", 1024)


DTYPES = {"float64": (None, None), "float32": (torch.float32, np.float32),
          "df32": ("df32", "df32")}
LAYOUT_CASES = {
    "4096": lambda: _both("random_diag_dominant", 4096),
    # 12 nonzeros a row: a 64-row block needs > 563 distinct columns, so
    # the destination blocks shrink to rb = 32 (F = 4 stacked windows)
    "20480_rb32": lambda: _both("random_diag_dominant", 20480,
                                nnz_per_row=12, seed=1),
    "rect": lambda: _rows(*_both("random_diag_dominant", 6000, seed=2),
                          2500),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_layout_tables_equal_jax(case, dtype):
    t, j = LAYOUT_CASES[case]()
    tdt, jdt = DTYPES[dtype]
    At = tbf.build_butterfly(t, dtype=tdt, device="cpu")
    Aj = jbf.build_butterfly(j, dtype=jdt)
    _assert_same_layout(At, Aj)
    assert At.tail_n > 0
    if case == "20480_rb32":
        assert At.rb == 32 and At.stack == 4
    if case == "rect":
        assert At.shape == (2500, 6000) and At.n_pad == 4096
    assert tbf.butterfly_stats(t) == jbf.butterfly_stats(j)
    assert native_route.library.cache_info().currsize == 1


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
    16-row block needs 1,120 distinct columns, more than a window
    holds."""
    n = 4096
    rows = np.repeat(np.arange(n, dtype=np.int64), 70)
    cols = (np.arange(n * 70, dtype=np.int64) * 59 + rows) % n
    return sparse.coo_to_csr(sparse.COOMatrix(
        np.concatenate([rows, np.arange(n)]),
        np.concatenate([cols, np.arange(n)]),
        np.concatenate([np.ones(rows.size), np.full(n, 80.0)]), (n, n)),
        sum_duplicates=True)


@pytest.mark.parametrize("case,kw,match", [
    ("wide", {}, "row width"),
    ("dense", {"max_width": 128}, "not butterfly-routable")])
def test_build_refuses_where_jax_refuses(case, kw, match):
    """Both builds raise ValueError on the same matrices (a row wider than
    max_width; blocks whose distinct columns overflow a window), and
    'auto' lands on gather-ELL in both (JAX ops/layout.py:120-130)."""
    make = _wide if case == "wide" else _dense_rows
    t, j = make(tgen, tsparse), make(jgen, jsparse)
    with pytest.raises(ValueError, match=match):
        tbf.build_butterfly(t, device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        jbf.build_butterfly(j, **kw)
    assert tlayout.auto_route(t)[0] == "butterfly"
    assert type(jlayout.build_operator(j, cache_dir="off")).__name__ \
        == type(tlayout.build_operator(t, device="cpu")).__name__ \
        == "EllMatrix"
    with pytest.raises(ValueError):
        tlayout.build_operator(t, format="butterfly", device="cpu")


@pytest.mark.parametrize("case", ["4096", "20480_rb32"])
def test_k3_lane_form_reads_the_xla_element(case):
    """For every placed slot of JAX's tables, the window the Pallas 'lane'
    form takes from the output lane (j // rb) is the one the full stacked
    sublane names (s // 8): the two forms read the same z element."""
    _, j = LAYOUT_CASES[case]()
    Aj = jbf.build_butterfly(j)
    W, NR = Aj.width, Aj.n_pad // 128
    lane = Aj.k3_lane.reshape(W, NR, 128).astype(np.int64)
    sub = np.take_along_axis(Aj.k3_sub.reshape(W, NR, 128).astype(np.int64),
                             lane, axis=2)
    placed = Aj.k3_vals.reshape(W, NR, 128) != 0
    out_win = np.broadcast_to(np.arange(128) // Aj.rb, placed.shape)
    assert placed.sum() == Aj.nnz - Aj.tail_n
    np.testing.assert_array_equal((sub // 8)[placed], out_win[placed])


def _layout(t, j, dtype):
    tdt, jdt = DTYPES[dtype]
    return (tbf.build_butterfly(t, dtype=tdt, device="cpu"),
            jbf.build_butterfly(j, dtype=jdt))


def _random_tables(A, seed):
    """A with random K1/K2 tables (every lane and sublane, every source
    window including the last): K1 reads past the last column where
    n_cols is not a multiple of 1024."""
    g = np.random.default_rng(seed)

    def rand(hi, dtype=np.int8):
        return torch.as_tensor(g.integers(0, hi, (A.P, 8, 128)).astype(dtype))
    src = g.integers(0, A.nc_pad // 1024, A.P).astype(np.int32)
    src[:4] = A.nc_pad // 1024 - 1
    return dataclasses.replace(A, k1_src=torch.as_tensor(src),
                               k1_sub=rand(8), k1_lane=rand(128),
                               k2_sub=rand(8), k2_lane=rand(128))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("tables", ["routed", "random"])
def test_k1_k2_twins_equal_jax_kernels(dtype, tables, monkeypatch):
    """K1 and K2's twins against JAX's _k1 / _k2 (interpret mode) on 4
    windows, two per grid step, each followed by JAX's transpose (T1, T2
    as pallas_butterfly.py:274,276 write them; the twins write their
    output transposed): equal. 3000 columns (nc_pad 3072): the random
    tables' first windows read the last source window, where K1 reads 0
    past column 2999 as JAX's zero-padded x does."""
    monkeypatch.setattr(jpb, "_tb_windows", lambda P: 2)
    t, j = _both("random_diag_dominant", 3000, seed=3)
    A = tbf.build_butterfly(t, dtype=dtype, device="cpu")
    if tables == "random":
        A = _random_tables(A, 5)
        col = tbs._slot_elem(A.k1_sub, A.k1_lane, A.k1_src)[: 4 * 1024]
        assert (col >= A.n_cols).any()
    nw, npd = 4, np.dtype(str(dtype)[6:])
    x = np.random.default_rng(0).standard_normal(A.n_cols).astype(npd)
    xp = np.zeros(A.nc_pad, npd)
    xp[: A.n_cols] = x
    names = ("k1_src", "k1_sub", "k1_lane", "k2_sub", "k2_lane")
    sl = {k: jnp.asarray(getattr(A, k)[:nw].numpy()) for k in names}
    sub = types.SimpleNamespace(P=nw, n_cols=A.n_cols, nc_pad=A.nc_pad,
                                **{k: getattr(A, k)[:nw] for k in names})
    u1j = jpb._k1(sl["k1_src"], sl["k1_sub"], sl["k1_lane"],
                  jnp.asarray(xp.reshape(-1, 128)), interpret=True)
    np.testing.assert_array_equal(
        tbs.k1_plain(sub, torch.as_tensor(x)).numpy(),
        np.asarray(u1j).reshape(nw, 1024).T.reshape(-1))
    mid = np.random.default_rng(1).standard_normal(nw * 1024).astype(npd)
    z1j = jpb._k2(jnp.asarray(mid.reshape(nw, 8, 128)), sl["k2_sub"],
                  sl["k2_lane"], interpret=True)
    np.testing.assert_array_equal(
        tbs.k2_plain(sub, torch.as_tensor(mid)).numpy(),
        np.asarray(z1j).reshape(nw, 1024).T.reshape(-1))


K3_TILES = 3        # row tiles handed to JAX's K3 (from tile 5 on)


def _xla_route(A, xp):
    """JAX's z for the zero-padded x [nc_pad]: the routing lines of its
    XLA form (mpi_bicgstab_tpu/ops/butterfly.py butterfly_spmv_xla), on
    A's tables (equal to JAX's)."""
    t = {k: jnp.asarray(getattr(A, k).numpy()) for k in
         ("k1_src", "k1_sub", "k1_lane", "k2_sub", "k2_lane")}
    win = jnp.asarray(xp).reshape(A.nc_pad // 1024, 8, 128)[t["k1_src"]]
    t1 = jnp.take_along_axis(win, t["k1_sub"].astype(jnp.int32), axis=1)
    u1 = jnp.take_along_axis(t1, t["k1_lane"].astype(jnp.int32), axis=2)
    mid = u1.reshape(A.P, 1024).T.reshape(A.P, 8, 128)
    t2 = jnp.take_along_axis(mid, t["k2_sub"].astype(jnp.int32), axis=1)
    z1 = jnp.take_along_axis(t2, t["k2_lane"].astype(jnp.int32), axis=2)
    return z1.reshape(A.P, 1024).T.reshape(-1)


@pytest.mark.parametrize("dtype", ["float32", "float64", "df32"])
@pytest.mark.parametrize("case", ["4096", "20480_rb32"])
def test_k3_twins_match_jax_kernels(case, dtype, monkeypatch):
    """K3's twins on x (through the column table) against JAX's _k3 /
    _k3_df (interpret mode, one row tile per grid step) on K3_TILES row
    tiles of z routed from the same random x by JAX's XLA routing."""
    monkeypatch.setattr(jpb, "_tb_rows", lambda NR: 1)
    t, j = LAYOUT_CASES[case]()
    A, _ = _layout(t, j, dtype)
    x = np.random.default_rng(4).standard_normal(A.n_cols)
    r0, F = 5, A.stack
    zs = slice(r0 * 8 * F * 128, (r0 + K3_TILES) * 8 * F * 128)
    ys = slice(r0 * 128, (r0 + K3_TILES) * 128)
    tiles = (slice(None), slice(None), slice(r0, r0 + K3_TILES))
    sub, lane = (jnp.asarray(getattr(A, k)[tiles].numpy())
                 for k in ("k3_sub", "k3_lane"))

    def z_tiles(v):
        xp = np.zeros(A.nc_pad, v.dtype)
        xp[: A.n_cols] = v
        return _xla_route(A, xp)[zs].reshape(-1, 128)
    if dtype == "df32":
        xt = df_from_f64(x)
        yt = df_to_f64(tbs.k3_df_plain(A, xt))[ys]
        v = A.k3_vals
        yj = jpb._k3_df(z_tiles(xt.hi.numpy()), z_tiles(xt.lo.numpy()), sub,
                        lane, JDF(jnp.asarray(v.hi[tiles].numpy()),
                                  jnp.asarray(v.lo[tiles].numpy())),
                        F=F, interpret=True)
        yj = np.asarray(yj[0], np.float64) + np.asarray(yj[1], np.float64)
        tol = 1e-10
    else:
        xt = torch.as_tensor(x, dtype=getattr(torch, dtype))
        yt = tbs.k3_plain(A, xt).double().numpy()[ys]
        yj = np.asarray(jpb._k3(z_tiles(xt.numpy()), sub, lane,
                                jnp.asarray(A.k3_vals[tiles].numpy()), F=F,
                                interpret=True), np.float64)
        tol = 1e-6 if dtype == "float32" else 1e-12
    assert np.abs(yj).max() > 1
    assert np.abs(yt - yj).max() <= tol * np.abs(yj).max()


def _spmv_pair(At, Aj, x):
    """(port y, JAX y) as float64 NumPy for x: the port's whole SpMV
    (layout.spmv) against JAX's XLA form of the pipeline."""
    if is_df(At.k3_vals):
        yt = df_to_f64(tlayout.spmv(At, df_from_f64(x)))
        yj = jdf_to_f64(jax.jit(jbf.butterfly_spmv_xla_df)(
            jax.tree_util.tree_map(jnp.asarray, Aj), jdf(x)))
        return yt, yj[: Aj.n_rows]
    dt = At.k3_vals.dtype
    yt = tlayout.spmv(At, torch.as_tensor(x, dtype=dt)).double().numpy()
    Ad = jax.tree_util.tree_map(jnp.asarray, Aj)
    yj = jax.jit(jbf.butterfly_spmv_xla)(
        Ad, jnp.asarray(x, np.dtype(str(dt)[6:])))
    return yt, np.asarray(yj, np.float64)[: Aj.n_rows]


TOL = {"float32": 1e-5, "float64": 1e-12, "df32": 1e-13}


@pytest.mark.parametrize("dtype", ["float32", "float64", "df32"])
@pytest.mark.parametrize("case", ["4096", "20480_rb32", "rect"])
def test_spmv_matches_jax_xla(case, dtype):
    """The whole SpMV (stages, transposes, the tail) against JAX's
    butterfly_spmv_xla / _df, and in float64 against the CSR product."""
    t, j = LAYOUT_CASES[case]()
    At, Aj = _layout(t, j, dtype)
    assert At.tail_n > 0
    x = np.random.default_rng(11).standard_normal(t.shape[1])
    yt, yj = _spmv_pair(At, Aj, x)
    assert yt.shape == (t.nrows,)
    scale = np.abs(yj).max()
    assert np.abs(yt - yj).max() <= TOL[dtype] * scale
    if dtype != "float32":
        np.testing.assert_allclose(yt, t.matvec(x), rtol=0,
                                   atol=TOL[dtype] * scale)


@pytest.mark.parametrize("dtype", ["float64", "df32"])
def test_layout_carried_across_by_convert(dtype):
    """A JAX-built layout through convert.operator_from_arrays('butterfly')
    multiplies as the port's own build of the same CSR (bit for bit) and
    as JAX's XLA form."""
    t, j = _both("random_diag_dominant", 4096, seed=6)
    own, Aj = _layout(t, j, dtype)
    arrays, meta = _jax_arrays(Aj)
    At = convert.operator_from_arrays("butterfly", arrays, meta,
                                      device="cpu")
    _assert_same_layout(At, Aj)
    x = np.random.default_rng(12).standard_normal(t.nrows)
    put = df_from_f64 if dtype == "df32" else torch.as_tensor
    for a, b in zip(_host(tlayout.spmv(At, put(x))),
                    _host(tlayout.spmv(own, put(x))), strict=True):
        np.testing.assert_array_equal(a, b)
    yt, yj = _spmv_pair(At, Aj, x)
    assert np.abs(yt - yj).max() <= TOL[dtype] * np.abs(yj).max()


def test_butterfly_with_values_equals_a_build_per_dtype():
    """chip_smoke routes the layout once on the host in float64 and casts
    it: the same tables as a build in each dtype."""
    t, _ = _both("random_diag_dominant", 4096, seed=7)
    host = tbf.build_butterfly(t, device="cpu")
    for dtype in (torch.float32, torch.float64, "df32"):
        cast = tbf.butterfly_with_values(host, dtype, device="cpu")
        built = tbf.build_butterfly(t, dtype=dtype, device="cpu")
        for k in KEYS:
            for a, b in zip(_host(getattr(cast, k)),
                            _host(getattr(built, k)), strict=True):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    with pytest.raises(TypeError):
        tbf.butterfly_with_values(cast, torch.float32, device="cpu")


def test_auto_picks_butterfly_as_jax_does():
    """'auto' on a uniform random matrix: butterfly in both packages, with
    the same tables; its SpMV is the CSR's product."""
    t, j = _both("random_diag_dominant", 4096, seed=1)
    At = tlayout.build_operator(t, dtype=torch.float32, device="cpu")
    Aj = jlayout.build_operator(j, dtype=np.float32, cache_dir="off")
    assert type(At).__name__ == type(Aj).__name__ == "ButterflyMatrix"
    assert tlayout.auto_route(t)[0] == "butterfly"
    _assert_same_layout(At, Aj)
    x = np.random.default_rng(1).standard_normal(t.nrows)
    y = tlayout.spmv(At, torch.as_tensor(x, dtype=torch.float32))
    assert y.shape == (t.nrows,)
    ref = t.matvec(x)
    assert np.abs(y.double().numpy() - ref).max() < 1e-5 * np.abs(ref).max()


# (dtype, method, tol) on uniform 2048; df32 at 1e-8 (fewer iterations:
# each DF SpMV routes a million-slot layout through the plain twins)
SOLVES = [("float64", "bicgstab", 1e-10),
          ("float32", "bicgstab", 1e-5),
          ("df32", "bicgstab", 1e-8),
          ("df32", "pipe_bicgstab", 1e-8)]


@pytest.mark.parametrize("dtype,method,tol", SOLVES)
def test_solve_on_butterfly_matches_jax(dtype, method, tol):
    t, j = _both("random_diag_dominant", 2048, seed=3)
    df = dtype == "df32"
    jdt = "df32" if df else getattr(jnp, dtype)
    pj = jprob.build_problem(j, dtype=jdt, multiple=1024, format="butterfly")
    rj = japi.solve(pj.A, pj.b, method=method,
                    cfg=JCfg(tol=tol, max_iter=300,
                             dtype=jnp.float32 if df else jdt))
    pt = tprob.build_problem(t, dtype=dtype if df else getattr(torch, dtype),
                             multiple=1024, format="butterfly", device="cpu")
    assert type(pt.A).__name__ == type(pj.A).__name__ == "ButterflyMatrix"
    rt = tapi.solve(pt.A, pt.b, method=method,
                    cfg=SolverConfig(tol=tol, max_iter=300, dtype=dtype))
    assert bool(rt.converged) and bool(rj.converged)
    assert abs(rt.n_iter - int(rj.n_iter)) <= 2
    x = df_to_f64(rt.x) if df else rt.x.double().numpy()
    err = np.abs(x - 1.0).max()
    assert err < (1e-3 if dtype == "float32" else 1e-7)
    if dtype == "float32":      # the stopping rule's error, as in JAX
        xj = np.asarray(rj.x, np.float64)
        np.testing.assert_allclose(err, np.abs(xj - 1.0).max(), rtol=0.05)


def _jax_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = jcli.main([*argv, "--platform", "cpu", "--json"])
    return code, json.loads(out.getvalue().strip().splitlines()[-1])


N_CLI = 2048     # uniform:1024 is one row tile: windowed-ELL takes it
CLI_TOL = "1e-8"


def test_cli_solves_uniform_as_jax_does():
    """`solve --matrix uniform:N` with the CLI defaults: the butterfly
    layout, converged in JAX's iterations within 2."""
    base = ["solve", "--matrix", f"uniform:{N_CLI}", "--tol", CLI_TOL]
    jcode, want = _jax_cli(base)
    got, res = cli.run_solve(cli.build_parser().parse_args(
        [*base, "--device", "cpu"]))
    assert jcode == 0 and want["converged"] and got["converged"]
    assert got["layout"] == "ButterflyMatrix" and got["n"] == N_CLI
    assert abs(got["total_iter"] - want["total_iter"]) <= 2
    assert float((res.x - 1.0).abs().max()) < 1e-6


def test_cli_precond_on_butterfly_matches_jax():
    """`solve --precond cheby:2` on the butterfly layout: the unfused
    Chebyshev chain over the butterfly SpMV, against JAX's API on its
    butterfly operator (its CLI takes ~3 s here; at degree 4 the port's
    chains of plain-twin SpMVs take ~7 s on the CPU)."""
    from mpi_bicgstab_tpu.ops.cheby import ChebyPrecond as JCheby
    base = ["solve", "--matrix", f"uniform:{N_CLI}", "--precond", "cheby:2",
            "--tol", CLI_TOL]
    got, res = cli.run_solve(cli.build_parser().parse_args(
        [*base, "--device", "cpu"]))
    j = jgen.random_diag_dominant(N_CLI, nnz_per_row=8, seed=0)
    pj = jprob.build_problem(j, multiple=1024)
    assert type(pj.A).__name__ == "ButterflyMatrix"
    prec = JCheby.parse("cheby:2").resolve(j)
    rj = japi.solve(pj.A, pj.b, cfg=JCfg(tol=float(CLI_TOL)), precond=prec)
    assert got["layout"] == "ButterflyMatrix" and got["converged"]
    assert bool(rj.converged)
    assert got["precond"] == f"cheby:2:{prec.lo}:{prec.hi}"
    assert abs(got["total_iter"] - int(rj.n_iter)) <= 2
    assert float((res.x - 1.0).abs().max()) < 1e-6


def test_cli_rhs_batch_on_butterfly_matches_jax(tmp_path):
    t = tgen.random_diag_dominant(N_CLI, nnz_per_row=8, seed=0)
    B = np.stack([t.matvec(np.ones(N_CLI)),
                  t.matvec(np.random.default_rng(0).standard_normal(N_CLI))])
    np.save(tmp_path / "B.npy", B)
    base = ["solve", "--matrix", f"uniform:{N_CLI}", "--rhs-batch",
            str(tmp_path / "B.npy"), "--tol", CLI_TOL]
    jcode, want = _jax_cli(base)
    got, res = cli.run_solve(cli.build_parser().parse_args(
        [*base, "--device", "cpu"]))
    assert jcode == 0 and all(want["converged"]) and all(got["converged"])
    assert got["batch"] == 2
    assert all(abs(a - b) <= 2 for a, b in zip(got["n_iter"],
                                               want["n_iter"]))
    assert float((res.x[0] - 1.0).abs().max()) < 1e-6


def test_cli_shifted_on_butterfly_matches_jax():
    base = ["solve-shifted", "--matrix", f"uniform:{N_CLI}", "--format",
            "butterfly", "--sigma-len", "4", "--seed", "1", "--tol", CLI_TOL]
    jcode, want = _jax_cli(base)
    rows, res = cli.run_solve_shifted(cli.build_parser().parse_args(
        [*base, "--device", "cpu"]))
    got = rows[0]
    assert jcode == 0 and want["all_converged"] and got["all_converged"]
    assert abs(got["total_iter"] - want["total_iter"]) <= 2
    assert got["final_seed"] == want["final_seed"]
    assert res.x_set.shape == (4, N_CLI)


def test_native_router_builds_outside_the_jax_package():
    """The port's router library lives under the repository's build/
    tree, keyed by its source and the host, never beside the source."""
    path = native_route.lib_path()
    native_route.library()
    assert path.exists() and path.parent.parent.name == "host"
    assert path.parents[2].name == "build"
    assert not (native_route.SRC.parent / path.name).exists()


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


N_SMOKE = 4000      # padded to 4096 rows, as uniform:1602112 is


@pytest.mark.parametrize("phase", ["butterfly", "butterfly_f64",
                                   "butterfly_df32", "butterfly_pipe_df32"])
def test_chip_smoke_butterfly_phases_on_cpu(phase):
    """chip_smoke's butterfly phases at a small size on the CPU (the twins,
    no launches): the column tables, K3 against the routed pipeline on x
    with NaN and inf, the whole float64 SpMV against the CSR product,
    converged, within 2 iterations of gather-ELL."""
    smoke = _chip_smoke()
    csr = smoke.uniform_csr(N_SMOKE)
    inp = smoke.butterfly_inputs(csr, device="cpu")
    smoke.check_column_tables(inp)
    smoke.check_butterfly_staged(inp)
    assert smoke.check_butterfly_spmv(inp) <= 1e-12
    probs = smoke.butterfly_problems(inp, device="cpu")
    if phase == "butterfly":
        counts = smoke.run_butterfly_cli(N_SMOKE, probs["float32"][1],
                                         device="cpu")
    else:
        counts = smoke.run_butterfly_api(phase, probs, device="cpu")
    assert not any(counts.values())


def test_chip_smoke_butterfly_work_counts_the_stage_bytes():
    """butterfly_work at a small size: K1's tables, k1_src, x and u1 (4-
    or 8-byte elements); K2's tables, mid and z1; K3's column table and
    values, x and y; the whole SpMV adds the tail."""
    smoke = _chip_smoke()
    inp = smoke.butterfly_inputs(smoke.uniform_csr(N_SMOKE), device="cpu")
    B, held = inp["B32"], inp["b_csr"].nnz - inp["B32"].tail_n
    S, slots = B.P * 1024, B.width * B.n_pad
    k1, f1, _ = smoke.butterfly_work("butterfly_k1", inp)
    assert (k1, f1) == (2 * S + 4 * B.P + 4 * B.n_cols + 4 * S, 0)
    assert smoke.butterfly_work("butterfly_k2_b64", inp)[:2] == (18 * S, 0)
    k3, f3, dt = smoke.butterfly_work("butterfly_k3_f64", inp)
    assert dt == "float64" and f3 == 2 * held
    assert k3 == 12 * slots + 8 * B.n_cols + 8 * B.n_pad
    assert smoke.butterfly_work("butterfly_k3_f32", inp)[0] \
        == 8 * slots + 4 * B.n_cols + 4 * B.n_pad
    assert smoke.butterfly_work("butterfly_k3_df", inp)[1] == 18 * held
    whole = smoke.butterfly_work("butterfly_spmv_f32", inp)[0]
    parts = smoke.butterfly_work("butterfly_k3_f32", inp)[0]
    assert whole == parts + B.tail_n * 24


def test_chip_smoke_butterfly_launch_rule():
    smoke = _chip_smoke()
    zero = dict.fromkeys(("butterfly_k1", "butterfly_k2", "butterfly_decode",
                          "butterfly_k3", "butterfly_k3_df", "dia_spmv",
                          "fused_body_a", "fused_body_b"), 0)
    check = smoke.check_butterfly_counts
    built = {"butterfly_k1": 1, "butterfly_k2": 1, "butterfly_decode": 1}
    # classic, 10 iterations in one segment: 2 per iteration + r0 + true;
    # the layout built before the count, then inside it (the CLI run)
    check("rule", "bicgstab", "float32", 10, {**zero, "butterfly_k3": 22},
          restarts=2)
    check("rule", "bicgstab", "float32", 10,
          {**zero, **built, "butterfly_k3": 22}, restarts=2, layouts=1)
    # df32 classic: the classic bodies and kernel 11 once per iteration
    passes = dict.fromkeys(smoke.df32_passes("bicgstab", "df32"), 10)
    check("rule", "bicgstab", "df32", 10,
          {**zero, "butterfly_k3_df": 22, **passes}, restarts=2)
    check("rule", "pipe_bicgstab", "df32", 10,
          {**zero, "butterfly_k3_df": 24, "fused_body_a": 10,
           "fused_body_b": 10}, restarts=2)
    check("rule", "bicgstab", "float32", 10, zero, restarts=2, device="cpu")
    check("rule", "bicgstab", "float32", 10, zero, restarts=2, device="cpu",
          layouts=1)
    for bad, layouts in (
            ({**zero, **built, "butterfly_k3": 22}, 0),   # K1, K2 per run
            ({**zero, "butterfly_k3": 22}, 1),            # no table build
            ({**zero, **built, "butterfly_decode": 0,
              "butterfly_k3": 22}, 1),                    # no decode
            ({**zero, "butterfly_k1": 22, "butterfly_k2": 22,
              "butterfly_decode": 22, "butterfly_k3": 22}, 1),  # per SpMV
            ({**zero, "butterfly_k3_df": 22}, 0),
            ({**zero, "butterfly_k3": 22, "dia_spmv": 1}, 0),
            ({**zero, "butterfly_k3": 30}, 0)):
        with pytest.raises(smoke.SmokeFailure):
            check("rule", "bicgstab", "float32", 10, bad, restarts=2,
                  layouts=layouts)
    with pytest.raises(smoke.SmokeFailure):     # bodies missing
        check("rule", "pipe_bicgstab", "df32", 10,
              {**zero, "butterfly_k3_df": 24}, restarts=2)
    with pytest.raises(smoke.SmokeFailure):     # classic bodies missing
        check("rule", "bicgstab", "df32", 10,
              {**zero, "butterfly_k3_df": 22}, restarts=2)
