"""The port's layout cache (utils/opcache.py, ops/layout.build_operator
(cache_dir=...), models/problem.build_problem(layout_cache=...), the
CLI's --layout-cache), after the JAX package's tests/test_opcache.py.

A cached operator must be indistinguishable from a fresh build: the same
class and every field (the derived ones, WindowEllMatrix.rc_* and
ButterflyMatrix.k3_col, rebuilt by __post_init__ on load) equal, for the
five layouts in float32, float64 and df32, and the same SpMV bit for
bit. The key changes with any value, shape or build option; a corrupt
entry is rebuilt; MBT_LAYOUT_CACHE is the default directory; the JAX
package and the port never load each other's entries.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.ops.layout as jlayout
from mpi_bicgstab_tpu_torch import cli
from mpi_bicgstab_tpu_torch.models.generators import (banded_random,
                                                      clustered_random,
                                                      random_diag_dominant)
from mpi_bicgstab_tpu_torch.models.problem import build_problem
from mpi_bicgstab_tpu_torch.ops.layout import build_operator, spmv
from mpi_bicgstab_tpu_torch.ops.precision import df_from_f64, df_to_f64, is_df
from mpi_bicgstab_tpu_torch.ops.sparse import COOMatrix, coo_to_csr
from mpi_bicgstab_tpu_torch.utils import opcache

torch.set_num_threads(1)


def _hybrid():
    """A band plus a few stragglers off every diagonal: DIA + ELL."""
    csr = banded_random(1024, [1, -1, 9, -9], seed=1)
    rows = np.repeat(np.arange(csr.nrows), csr.row_lengths)
    extra = np.random.default_rng(0).integers(0, 1024, (2, 40))
    coo = COOMatrix(np.r_[rows, extra[0]], np.r_[csr.col, extra[1]],
                    np.r_[csr.val, np.full(40, 0.01)], csr.shape)
    return coo_to_csr(coo, sum_duplicates=True)


LAYOUTS = {
    "dia": (lambda: banded_random(1024, [1, -1, 9, -9], seed=0), "dia",
            "DiaMatrix"),
    "hybrid": (_hybrid, "auto", "HybridMatrix"),
    "ell": (lambda: random_diag_dominant(512, nnz_per_row=6, seed=0), "ell",
            "EllMatrix"),
    "window": (lambda: clustered_random(2048), "window", "WindowEllMatrix"),
    "butterfly": (lambda: random_diag_dominant(2048, nnz_per_row=6, seed=0),
                  "butterfly", "ButterflyMatrix"),
}
DTYPES = [torch.float32, torch.float64, "df32"]


def _equal(a, b, path="op"):
    """Every field, derived ones included, equal (tensors in dtype, shape
    and bits; DF pairs in both halves)."""
    if dataclasses.is_dataclass(a):
        assert type(a) is type(b), path
        for f in dataclasses.fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name),
                   f"{path}.{f.name}")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def _host(y):
    return df_to_f64(y) if is_df(y) else y.double().numpy()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64", "df32"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_roundtrip_equals_the_fresh_build(tmp_path, layout, dtype):
    make, fmt, cls = LAYOUTS[layout]
    csr = make()
    fresh = build_operator(csr, format=fmt, dtype=dtype, device="cpu",
                           cache_dir="off")
    built = build_operator(csr, format=fmt, dtype=dtype, device="cpu",
                           cache_dir=str(tmp_path))        # build + save
    assert len(list(tmp_path.glob("torch_layout_*.npz"))) == 1
    cached = build_operator(csr, format=fmt, dtype=dtype, device="cpu",
                            cache_dir=str(tmp_path))       # load
    assert type(cached).__name__ == cls
    _equal(fresh, built)
    _equal(fresh, cached)
    x_host = np.random.default_rng(0).standard_normal(csr.shape[1])
    x = df_from_f64(x_host, "cpu") if dtype == "df32" else \
        torch.as_tensor(x_host, dtype=dtype)
    want = _host(spmv(fresh, x))
    assert np.array_equal(_host(spmv(cached, x)).view(np.int64),
                          want.view(np.int64))


def test_key_sensitivity():
    csr = banded_random(512, [1, -1, 7, -7], seed=0)
    base = opcache.operator_key(csr, format="auto", dtype="float32",
                                ell_width=None)
    assert base == opcache.operator_key(csr, format="auto",
                                        dtype="float32", ell_width=None)
    for kw in ({"format": "dia", "dtype": "float32", "ell_width": None},
               {"format": "auto", "dtype": "df32", "ell_width": None},
               {"format": "auto", "dtype": "float32", "ell_width": 4}):
        assert base != opcache.operator_key(csr, **kw)
    csr2 = banded_random(512, [1, -1, 7, -7], seed=1)     # other values
    assert base != opcache.operator_key(csr2, format="auto",
                                        dtype="float32", ell_width=None)
    csr3 = dataclasses.replace(csr, col=csr.col.astype(np.int32))
    assert base != opcache.operator_key(csr3, format="auto",
                                        dtype="float32", ell_width=None)


def test_corrupt_entry_is_rebuilt(tmp_path):
    csr = banded_random(512, [1, -1, 7, -7], seed=0)
    op = build_operator(csr, format="dia", dtype=torch.float32,
                        device="cpu", cache_dir=str(tmp_path))
    (entry,) = tmp_path.glob("torch_layout_*.npz")
    whole = entry.read_bytes()
    for bad in (b"not an npz", whole[: len(whole) // 2]):   # cut short
        entry.write_bytes(bad)
        op2 = build_operator(csr, format="dia", dtype=torch.float32,
                             device="cpu", cache_dir=str(tmp_path))
        _equal(op, op2)
    # the rebuilt entry replaced the corrupt one and loads
    key = entry.name.removeprefix("torch_layout_").removesuffix(".npz")
    _equal(op, opcache.load_operator(str(tmp_path), key, "cpu"))


def test_failed_save_warns_and_runs_uncached(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("a file where the cache directory should be")
    csr = banded_random(256, [1, -1, 5, -5], seed=0)
    with pytest.warns(UserWarning, match="layout cache write failed"):
        op = build_operator(csr, format="dia", dtype=torch.float64,
                            device="cpu", cache_dir=str(blocker / "sub"))
    assert type(op).__name__ == "DiaMatrix"
    with pytest.warns(UserWarning, match="unsupported value"):
        assert opcache.save_operator(str(tmp_path), "k", object()) is None


def test_env_default_cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("MBT_LAYOUT_CACHE", str(tmp_path))
    csr = banded_random(512, [1, -1, 7, -7], seed=0)
    build_operator(csr, format="dia", dtype=torch.float32, device="cpu")
    assert len(list(tmp_path.glob("torch_layout_*.npz"))) == 1
    # an explicit '0' disables it even with the variable set
    build_operator(csr, format="ell", dtype=torch.float32, device="cpu",
                   cache_dir="0")
    assert len(list(tmp_path.glob("torch_layout_*.npz"))) == 1
    monkeypatch.setenv("MBT_LAYOUT_CACHE", "off")
    build_operator(csr, format="ell", dtype=torch.float32, device="cpu")
    assert len(list(tmp_path.glob("torch_layout_*.npz"))) == 1


def test_no_cross_package_hit(tmp_path):
    """Both packages share MBT_LAYOUT_CACHE's directory: each writes its
    own entry and loads only its own, even where a file name or a key
    coincides."""
    csr = banded_random(512, [1, -1, 7, -7], seed=0)
    jop = jlayout.build_operator(csr, format="dia", dtype=np.float32,
                                 cache_dir=str(tmp_path))
    (jentry,) = tmp_path.glob("layout_*.npz")
    op = build_operator(csr, format="dia", dtype=torch.float32,
                        device="cpu", cache_dir=str(tmp_path))
    assert len(list(tmp_path.glob("torch_layout_*.npz"))) == 1
    assert len(list(tmp_path.glob("*.npz"))) == 2
    jop2 = jlayout.build_operator(csr, format="dia", dtype=np.float32,
                                  cache_dir=str(tmp_path))
    assert type(jop2) is type(jop) and type(op).__name__ == "DiaMatrix"
    # a JAX entry planted under the port's name for a port key: refused
    (entry,) = tmp_path.glob("torch_layout_*.npz")
    key = entry.name.removeprefix("torch_layout_").removesuffix(".npz")
    entry.write_bytes(jentry.read_bytes())
    assert opcache.load_operator(str(tmp_path), key, "cpu") is None
    with np.load(jentry) as z:
        assert "format" not in json.loads(str(z["__meta__"]))


def test_build_problem_and_the_cli_take_the_cache(tmp_path, capsys):
    """build_problem(layout_cache=...) and `solve --layout-cache` (the
    CLI's 1024-padded butterfly route): the second solve loads the
    layout, and its report equals the first's apart from the times."""
    csr = clustered_random(2048)
    p1 = build_problem(csr, dtype=torch.float32, device="cpu",
                       multiple=1024, layout_cache=str(tmp_path / "p"))
    p2 = build_problem(csr, dtype=torch.float32, device="cpu",
                       multiple=1024, layout_cache=str(tmp_path / "p"))
    _equal(p1.A, p2.A)
    argv = ["solve", "--matrix", "uniform:2000", "--tol", "1e-8",
            "--layout-cache", str(tmp_path / "c"), "--device", "cpu"]
    reports = [cli.run_solve(cli.build_parser().parse_args(argv))[0]
               for _ in range(2)]
    (entry,) = (tmp_path / "c").glob("torch_layout_*.npz")
    assert os.path.getsize(entry) > 0
    timing = {"io_time_s", "setup_s", "total_time_s", "avg_time_per_iter_s"}
    a, b = ({k: v for k, v in r.items() if k not in timing}
            for r in reports)
    assert a == b and a["layout"] == "ButterflyMatrix" and a["converged"]
