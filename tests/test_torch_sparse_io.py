"""The port's host I/O against the JAX package: the native Matrix Market
parser (io/native.py over its own csrc/mmio_fast.cpp, hooked into
io/mmio.read_matrix_market), the binary CSR container (save_csr /
load_csr_npz), the sparse helpers (to_dense, shift_diagonal,
csr_from_scipy, csr_from_torch, dia_to_dense, ell_to_dense).

Every parse is held bit for bit (the same int64 indices, the same
float64 values) to the JAX package's native and NumPy parses and to the
port's NumPy path (use_native=False); the helpers' outputs equal JAX's
exactly.
"""
import gzip
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.io.mmio as jmmio
import mpi_bicgstab_tpu.ops.dia as jdia
import mpi_bicgstab_tpu.ops.ell as jell
import mpi_bicgstab_tpu.ops.sparse as jsparse
from mpi_bicgstab_tpu_torch.io import mmio, native
from mpi_bicgstab_tpu_torch.models.generators import (banded_random,
                                                      random_diag_dominant,
                                                      transport_like)
from mpi_bicgstab_tpu_torch.ops import sparse
from mpi_bicgstab_tpu_torch.ops.dia import csr_to_dia, dia_to_dense
from mpi_bicgstab_tpu_torch.ops.ell import csr_to_ell, ell_to_dense
from mpi_bicgstab_tpu_torch.ops.precision import df_from_f64, df_to_f64
from mpi_bicgstab_tpu_torch.utils import host_build

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def _mtx(path, body_lines, header="real general", shape=None, nnz=None):
    lines = [f"%%MatrixMarket matrix coordinate {header}", "% a comment"]
    n = shape or 6
    lines.append(f"{n} {n} {nnz or len(body_lines)}")
    path.write_text("\n".join(lines + body_lines) + "\n")
    return path


def _entries(rng, n=6, k=14, pattern=False, lower=False):
    out = set()
    while len(out) < k:
        r, c = (int(v) for v in rng.integers(1, n + 1, 2))
        if lower and c > r:
            r, c = c, r
        out.add((r, c))
    vals = ["-1.5e-3", "2.25E+02", "+0.125", "-7", "3.0000000000000004",
            "1e-300", "-0.0"]
    return [f"{r} {c}" if pattern else f"{r} {c} {vals[i % len(vals)]}"
            for i, (r, c) in enumerate(sorted(out))]


def _same(a, b):
    for x, y in zip(a[:3], b[:3]):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x.view(np.int64), y.view(np.int64))
    assert tuple(a[3]) == tuple(b[3])


def _all_parses(path):
    """The port's native parse, held to the port's NumPy path and to the
    JAX package's native and NumPy parses."""
    got = mmio.read_matrix_market(str(path))
    for other in (mmio.read_matrix_market(str(path), use_native=False),
                  jmmio.read_matrix_market(str(path)),
                  jmmio.read_matrix_market(str(path), use_native=False)):
        _same(got, other)
    return got


@pytest.mark.parametrize("kind", ["general", "pattern", "symmetric",
                                  "skew-symmetric", "gzip"])
def test_native_parse_bit_equal_to_jax_and_numpy(tmp_path, kind):
    rng = np.random.default_rng(3)
    body = _entries(rng, pattern=kind == "pattern",
                    lower=kind.endswith("symmetric"))
    header = {"pattern": "pattern general", "symmetric": "real symmetric",
              "skew-symmetric": "real skew-symmetric"}.get(kind,
                                                           "real general")
    path = _mtx(tmp_path / "a.mtx", body, header)
    if kind == "gzip":
        gz = tmp_path / "a.mtx.gz"
        gz.write_bytes(gzip.compress(path.read_bytes()))
        path = gz
    rows, cols, vals, shape = _all_parses(path)
    assert shape == (6, 6)
    if kind == "pattern":
        assert (vals == 1.0).all()


def test_native_parse_of_a_large_body_splits_lines_across_threads(tmp_path):
    """A body over 1 MB is cut into one chunk per thread at byte offsets
    that fall inside lines: every entry is still read once, bit for bit
    (%.17g round-trips float64)."""
    csr = transport_like(8000)
    rows = np.repeat(np.arange(csr.nrows), csr.row_lengths)
    path = tmp_path / "t.mtx"
    mmio.write_matrix_market(path, rows, csr.col, csr.val, csr.shape)
    assert path.stat().st_size > 2 << 20
    body = path.read_bytes().split(b"\n", 2)[2]
    for threads in (1, 3, 7):
        r, c, v = native.parse_body_native(body, csr.nnz, False, threads)
        assert np.array_equal(r, rows) and np.array_equal(c, csr.col)
        assert np.array_equal(v.view(np.int64), csr.val.view(np.int64))
    got = _all_parses(path)
    back = sparse.coo_to_csr(sparse.COOMatrix(*got))
    assert np.array_equal(back.ptr, csr.ptr)


def test_mid_body_comment_and_the_numpy_retry(tmp_path, monkeypatch):
    """A `%` line in the body, and a body whose entries break across lines
    (the native scan counts lines, so it refuses it with ValueError and
    the reader re-reads it on the NumPy path, as JAX's does)."""
    rng = np.random.default_rng(5)
    body = _entries(rng)
    path = _mtx(tmp_path / "c.mtx", body[:5] + ["% mid-body"] + body[5:],
                nnz=len(body))
    _all_parses(path)
    broken = [f"{ln.rsplit(' ', 1)[0]}\n{ln.rsplit(' ', 1)[1]}"
              for ln in body]
    path = _mtx(tmp_path / "b.mtx", broken)
    calls = []
    real = mmio._parse_body
    monkeypatch.setattr(mmio, "_parse_body",
                        lambda *a: calls.append(1) or real(*a))
    with pytest.raises(ValueError):
        native.parse_body_native(path.read_bytes().split(b"\n", 3)[3],
                                 len(body), False)
    _all_parses(path)
    assert calls      # the native parse refused it: the NumPy path ran


def test_missing_gxx_raises(tmp_path, monkeypatch):
    """With no library on disk and no g++ on PATH, the native reader
    raises (the JAX package quietly takes its NumPy path instead)."""
    monkeypatch.setattr(host_build, "BUILD_ROOT", tmp_path / "host")
    monkeypatch.setattr(host_build.shutil, "which", lambda name: None)
    native.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            mmio.read_matrix_market(str(_mtx(tmp_path / "a.mtx",
                                             ["1 1 2.0"], shape=1)))
    finally:
        native.library.cache_clear()
    assert mmio.read_matrix_market(str(tmp_path / "a.mtx"),
                                   use_native=False)[2].tolist() == [2.0]


def test_native_library_builds_under_build_host_not_beside_its_source():
    path = native.lib_path()
    native.library()
    assert path.exists() and path.parents[1].name == "host"
    assert path.parents[2] == REPO / "build"
    assert not list(native.SRC.parent.glob("*.so"))
    # the port's own copy of the JAX package's source
    jsrc = REPO / "mpi_bicgstab_tpu" / "io" / "csrc" / "mmio_fast.cpp"
    strip = [ln for ln in jsrc.read_text().splitlines()
             if not ln.startswith("//")]
    assert strip == [ln for ln in native.SRC.read_text().splitlines()
                     if not ln.startswith("//")]


def test_write_then_read_round_trips_bit_for_bit(tmp_path):
    csr = random_diag_dominant(500, nnz_per_row=5, seed=2)
    rows = np.repeat(np.arange(csr.nrows), csr.row_lengths)
    path = tmp_path / "w.mtx"
    mmio.write_matrix_market(path, rows, csr.col, csr.val, csr.shape,
                             comment="two\nlines")
    got = sparse.load_csr(str(path))
    assert np.array_equal(got.ptr, csr.ptr)
    assert np.array_equal(got.col, csr.col)
    assert np.array_equal(got.val.view(np.int64), csr.val.view(np.int64))
    _same(mmio.read_matrix_market(str(path)),
          jmmio.read_matrix_market(str(path)))


def test_chip_smoke_writes_the_readers_bytes(tmp_path, monkeypatch):
    """chip_smoke.write_mtx (spawned formatters) writes the bytes of
    io/mmio.write_matrix_market."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    # registered, so that the spawned workers' target pickles by name
    monkeypatch.setitem(sys.modules, "chip_smoke", cs)
    monkeypatch.syspath_prepend(str(REPO))
    spec.loader.exec_module(cs)
    csr = transport_like(3000)
    rows = np.repeat(np.arange(csr.nrows), csr.row_lengths)
    mmio.write_matrix_market(tmp_path / "a.mtx", rows, csr.col, csr.val,
                             csr.shape)
    cs.write_mtx(tmp_path / "b.mtx", csr, procs=2)
    assert (tmp_path / "a.mtx").read_bytes() == \
        (tmp_path / "b.mtx").read_bytes()
    assert not list(tmp_path.glob("*.part*"))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_csr_npz_is_read_by_both_packages(tmp_path, writer):
    csr = banded_random(300, [1, -1, 7, -7], seed=1)
    path = str(tmp_path / "a.npz")
    if writer == "port":
        sparse.save_csr(path, csr)
        got = jsparse.load_csr_npz(path)
    else:
        jsparse.save_csr(path, jsparse.CSRMatrix(csr.ptr, csr.col, csr.val,
                                                 csr.shape))
        got = sparse.load_csr(path)
    assert got.shape == csr.shape
    for a, b in ((got.ptr, csr.ptr), (got.col, csr.col),
                 (got.val, csr.val)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match=".npz"):
        sparse.save_csr(str(tmp_path / "a.bin"), csr)


def test_dense_and_shift_helpers_equal_jax():
    csr = banded_random(200, [1, -1, 9, -9], seed=4)
    jcsr = jsparse.CSRMatrix(csr.ptr, csr.col, csr.val, csr.shape)
    assert np.array_equal(csr.to_dense(), jcsr.to_dense())
    rows = np.repeat(np.arange(csr.nrows), csr.row_lengths)
    dup = sparse.COOMatrix(np.r_[rows, 3], np.r_[csr.col, 4],
                           np.r_[csr.val, 2.5], csr.shape)
    jdup = jsparse.COOMatrix(dup.row, dup.col, dup.val, dup.shape)
    assert np.array_equal(dup.to_dense(), jdup.to_dense())
    for sigma in (0.0, 0.37, -2.0):
        got = csr.shift_diagonal(sigma)
        assert np.array_equal(got.val, jcsr.shift_diagonal(sigma).val)
        assert np.array_equal(got.to_dense(),
                              csr.to_dense() + sigma * np.eye(csr.nrows))
    no_diag = sparse.CSRMatrix(np.array([0, 1, 2]), np.array([1, 0]),
                               np.array([1.0, 1.0]), (2, 2))
    with pytest.raises(ValueError, match="row 0 has no structural"):
        no_diag.shift_diagonal(1.0)


def test_adapters_from_scipy_and_torch():
    sp = pytest.importorskip("scipy.sparse")
    csr = random_diag_dominant(120, nnz_per_row=4, seed=7)
    m = sp.csr_matrix((csr.val, csr.col, csr.ptr), shape=csr.shape)
    for got in (sparse.csr_from_scipy(m), sparse.csr_from_scipy(m.tocoo())):
        want = jsparse.csr_from_scipy(m)
        assert got.ptr.dtype == np.int64 and got.col.dtype == np.int64
        assert np.array_equal(got.to_dense(), want.to_dense())
    t = torch.sparse_csr_tensor(torch.as_tensor(csr.ptr),
                                torch.as_tensor(csr.col),
                                torch.as_tensor(csr.val), size=csr.shape,
                                check_invariants=True)
    for src in (t, t.to_sparse_coo()):
        got = sparse.csr_from_torch(src)
        assert got.val.dtype == np.float64 and got.shape == csr.shape
        assert np.array_equal(got.to_dense(), csr.to_dense())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, "df32"])
def test_dia_and_ell_to_dense_equal_jax(dtype):
    import jax.numpy as jnp
    csr = banded_random(256, [1, -1, 17, -17], seed=2)
    offsets = [-17, -1, 0, 1, 17]
    A, _ = csr_to_dia(csr, offsets, dtype=dtype, device="cpu")
    jdt = np.float64 if dtype == "df32" else \
        str(dtype).removeprefix("torch.")
    # df32 holds each float64 value as a float32 pair: its dense form is
    # the float64 one rounded through that split, entry by entry
    split = (lambda d: df_to_f64(df_from_f64(d))) if dtype == "df32" \
        else (lambda d: d)
    JA, _ = jdia.csr_to_dia(csr, offsets, dtype=jdt)
    assert np.array_equal(dia_to_dense(A), split(jdia.dia_to_dense(JA)))
    E = csr_to_ell(csr, width=3, dtype=dtype, device="cpu")
    JE = jell.csr_to_ell(csr, width=3, dtype=jnp.dtype(jdt))
    assert E.tail_size > 0
    assert np.array_equal(ell_to_dense(E), split(jell.ell_to_dense(JE)))
    assert np.array_equal(ell_to_dense(E), split(csr.to_dense().astype(
        ell_to_dense(E).dtype)))
