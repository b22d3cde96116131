"""Port vs JAX package: layout analysis, the DIA / hybrid / ELL layouts
and their SpMV.

Layouts: the same class, offsets and arrays as JAX (equal). SpMV: the
port's plain layout.spmv on the operator carried across from JAX's
arrays (convert.operator_from_arrays) against JAX's ops/layout.spmv,
rtol 1e-12 at float64 and 1e-5 at float32 (the same products summed in
the same diagonal order; the tolerance covers FMA contraction on either
side).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.models.generators as jgen
import mpi_bicgstab_tpu.ops.dia as jdia
import mpi_bicgstab_tpu.ops.layout as jlayout
import mpi_bicgstab_tpu.ops.sparse as jsparse
import mpi_bicgstab_tpu_torch.models.generators as tgen
import mpi_bicgstab_tpu_torch.ops.dia as tdia
import mpi_bicgstab_tpu_torch.ops.layout as tlayout
import mpi_bicgstab_tpu_torch.ops.sparse as tsparse
from mpi_bicgstab_tpu_torch import convert

torch.set_num_threads(1)


def _with_stragglers(sparse_mod, csr, k, seed):
    """csr plus k random off-band entries (each on its own rare offset)."""
    rng = np.random.default_rng(seed)
    n = csr.nrows
    rows = np.repeat(np.arange(n), csr.row_lengths)
    r = rng.integers(0, n, k)
    c = rng.integers(0, n, k)
    coo = sparse_mod.COOMatrix(np.concatenate([rows, r]),
                               np.concatenate([csr.col, c]),
                               np.concatenate([csr.val,
                                               rng.uniform(-1, 1, k)]),
                               csr.shape)
    return sparse_mod.coo_to_csr(coo, sum_duplicates=True)


def _pair(kind):
    """The same host CSR built by each package."""
    if kind == "dia":
        return (tgen.transport_like(4096, seed=3),
                jgen.transport_like(4096, seed=3))
    if kind == "hybrid":
        return (_with_stragglers(tsparse,
                                 tgen.banded_random(3000, [1, -1, 50, -50],
                                                    seed=4), 400, 5),
                _with_stragglers(jsparse,
                                 jgen.banded_random(3000, [1, -1, 50, -50],
                                                    seed=4), 400, 5))
    # unstructured: random columns, no diagonal holds 2% of the rows
    rng = np.random.default_rng(6)
    n, k = 2048, 6
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, n * k)
    vals = rng.uniform(-1, 1, n * k)
    return tuple(m.coo_to_csr(m.COOMatrix(rows, cols, vals, (n, n)),
                              sum_duplicates=True)
                 for m in (tsparse, jsparse))


def _arrays(op):
    """Kind, NumPy arrays and meta of a JAX operator, for convert."""
    if isinstance(op, jdia.DiaMatrix):
        return "dia", {"vals": np.asarray(op.vals)}, {
            "offsets": op.offsets, "n": op.n_rows}
    ell_keys = ("cols", "vals", "tail_rows", "tail_cols", "tail_vals")
    if isinstance(op, jlayout.HybridMatrix):
        arrays = {"dia_vals": np.asarray(op.dia.vals)}
        arrays.update({f"ell_{k}": np.asarray(getattr(op.ell, k))
                       for k in ell_keys})
        return "hybrid", arrays, {"offsets": op.dia.offsets,
                                  "n": op.dia.n_rows}
    return "ell", {k: np.asarray(getattr(op, k)) for k in ell_keys}, {
        "n_rows": op.n_rows, "n_cols": op.n_cols}


@pytest.mark.parametrize("kind", ["dia", "hybrid", "unstructured"])
def test_analyze_and_csr_to_dia_match(kind):
    t, j = _pair(kind)
    assert tdia.analyze_diagonals(t) == jdia.analyze_diagonals(j)
    offsets, _ = jdia.analyze_diagonals(j)
    if not offsets:
        return
    dt, remt = tdia.csr_to_dia(t, offsets, device="cpu")
    dj, remj = jdia.csr_to_dia(j, offsets)
    assert dt.offsets == dj.offsets and dt.shape == dj.shape
    np.testing.assert_array_equal(dt.vals.numpy(), np.asarray(dj.vals))
    assert (remt is None) == (remj is None)
    if remt is not None:
        np.testing.assert_array_equal(remt.ptr, remj.ptr)
        np.testing.assert_array_equal(remt.col, remj.col)
        np.testing.assert_array_equal(remt.val, remj.val)


@pytest.mark.parametrize("kind,cls", [("dia", "DiaMatrix"),
                                      ("hybrid", "HybridMatrix")])
def test_auto_layout_class_and_offsets_match(kind, cls):
    t, j = _pair(kind)
    opt = tlayout.build_operator(t, device="cpu")
    opj = jlayout.build_operator(j, cache_dir="off")
    assert type(opt).__name__ == type(opj).__name__ == cls
    dia_t = opt if cls == "DiaMatrix" else opt.dia
    dia_j = opj if cls == "DiaMatrix" else opj.dia
    assert dia_t.offsets == dia_j.offsets


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-12),
                                        ("float32", 1e-5)])
@pytest.mark.parametrize("kind,fmt", [("dia", "auto"), ("hybrid", "auto"),
                                      ("dia", "ell"), ("unstructured", "ell")])
def test_spmv_matches_jax(kind, fmt, dtype, rtol):
    t, j = _pair(kind)
    opj = jlayout.build_operator(j, format=fmt, dtype=np.dtype(dtype),
                                 cache_dir="off")
    opt = convert.operator_from_arrays(*_arrays(opj), device="cpu")
    assert type(opt).__name__ == type(opj).__name__
    # the port's own build gives the same operator
    own = tlayout.build_operator(t, format=fmt, dtype=dtype, device="cpu")
    assert type(own).__name__ == type(opj).__name__
    x = np.random.default_rng(7).standard_normal(t.nrows)
    yj = np.asarray(jlayout.spmv(opj, jnp.asarray(x, dtype)))
    for op in (opt, own):
        yt = tlayout.spmv(op, torch.as_tensor(x, dtype=getattr(torch,
                                                                dtype)))
        assert yt.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(yt.numpy(), yj, rtol=rtol)


def test_unported_layouts_raise():
    """Every layout is ported now: 'butterfly', and 'auto' on a matrix with
    neither diagonals nor window locality (which routes it there, as JAX
    does), build the butterfly layout and multiply as the CSR does, as
    does 'window' (the out-of-window entries go to its tail); an unknown
    format is still a ValueError."""
    t, j = _pair("unstructured")
    x = np.random.default_rng(8).standard_normal(t.nrows)
    assert type(jlayout.build_operator(j, cache_dir="off")).__name__ \
        == "ButterflyMatrix"
    for fmt in ("butterfly", "auto"):
        op = tlayout.build_operator(t, format=fmt, device="cpu")
        assert type(op).__name__ == "ButterflyMatrix"
        np.testing.assert_allclose(
            tlayout.spmv(op, torch.as_tensor(x)).numpy(), t.matvec(x),
            rtol=1e-12, atol=1e-12)
    op = tlayout.build_operator(t, format="window", device="cpu")
    assert type(op).__name__ == "WindowEllMatrix" and op.tail_size > 0
    np.testing.assert_allclose(tlayout.spmv(op, torch.as_tensor(x)).numpy(),
                               t.matvec(x), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        tlayout.build_operator(t, format="csr", device="cpu")


def test_config_from_jax_fields():
    import dataclasses

    from mpi_bicgstab_tpu.utils.config import SolverConfig as JCfg
    cfg = convert.config_from_fields(dataclasses.asdict(
        JCfg(tol=1e-7, max_iter=33, restarts=1, dtype=jnp.float32)))
    assert (cfg.tol, cfg.max_iter, cfg.restarts, cfg.dtype) == (
        1e-7, 33, 1, torch.float32)
    # the distributed no-overlap mode is carried
    assert convert.config_from_fields(dataclasses.asdict(
        JCfg(serialize_comm=True))).serialize_comm is True
    # df32 is ported: its config dtype is float32, as in the JAX package
    assert convert.config_from_fields({"dtype": "df32"}).dtype \
        == torch.float32
