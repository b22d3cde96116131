"""The port's row partition (mpi_bicgstab_tpu_torch/parallel/partition.py)
against the JAX package's (mpi_bicgstab_tpu/parallel/partition.py), array
by array, on the same host CSR: every format, both DIA modes, uneven n,
N = 2, 4 and 8 shards; the butterfly shards' shared routing geometry; the
layout cache; and the small ops surfaces the distributed layer uses
(ell_spmv_shifted, EllMatrix.nnz_stored, DiaMatrix.pad, the ops re-
exports). Single-process: no ranks are started here."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.ops as jops
import mpi_bicgstab_tpu_torch.ops as tops
from mpi_bicgstab_tpu.models import generators as jgen
from mpi_bicgstab_tpu.ops.butterfly import build_butterfly as j_build_bf
from mpi_bicgstab_tpu.ops.dia import csr_to_dia as j_csr_to_dia
from mpi_bicgstab_tpu.ops.ell import csr_to_ell as j_csr_to_ell
from mpi_bicgstab_tpu.ops.spmv import ell_spmv_shifted as j_ell_shifted
from mpi_bicgstab_tpu.parallel.partition import partition_csr as j_partition
from mpi_bicgstab_tpu_torch.models import generators as tgen
from mpi_bicgstab_tpu_torch.ops.butterfly import butterfly_tables
from mpi_bicgstab_tpu_torch.ops.dia import csr_to_dia as t_csr_to_dia
from mpi_bicgstab_tpu_torch.ops.ell import csr_to_ell as t_csr_to_ell
from mpi_bicgstab_tpu_torch.ops.spmv import ell_spmv_shifted as t_ell_shifted
from mpi_bicgstab_tpu_torch.parallel.partition import (PartitionedMatrix,
                                                       partition_csr)

torch.set_num_threads(1)
ARRAYS = [f.name for f in dataclasses.fields(PartitionedMatrix)
          if f.name not in ("dia_offsets", "win_width", "win_tail_counts",
                            "bf_meta", "halo", "dia_mode", "n_devices",
                            "n_loc", "n_global", "n_logical")]
META = ("dia_offsets", "win_width", "bf_meta", "halo", "dia_mode",
        "n_devices", "n_loc", "n_global", "n_logical")


def _both(name, *args, **kw):
    """The same generator in each package: (port CSR, JAX CSR)."""
    t, j = getattr(tgen, name)(*args, **kw), getattr(jgen, name)(*args, **kw)
    for k in ("ptr", "col", "val"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
    return t, j


def _halves(a):
    return (a.hi, a.lo) if hasattr(a, "hi") else (a,)


def assert_same_partition(tp, jp):
    for k in META:
        got, want = getattr(tp, k), getattr(jp, k)
        if k == "bf_meta" and want is not None:
            want = tuple(int(v) for v in want)
        assert got == want, k
    for k in ARRAYS:
        got, want = getattr(tp, k), getattr(jp, k)
        assert (got is None) == (want is None), k
        if got is None:
            continue
        gh, wh = _halves(got), _halves(want)
        assert len(gh) == len(wh), k
        for g, w in zip(gh, wh):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=k)


CASES = {   # format -> (generator, args, kwargs, n_devices)
    "auto": ("banded_random", (1000, [1, -1, 9, -9]), {"seed": 0}, 4),
    "dia": ("banded_random", (1000, [1, -1, 9, -9, 30]), {"seed": 1}, 2),
    "ell": ("banded_random", (1000, [1, -1, 9, -9]), {"seed": 2}, 4),
    "window": ("clustered_random", (4096,), {}, 2),
    "butterfly": ("random_diag_dominant", (4096,),
                  {"nnz_per_row": 6, "seed": 0}, 2),
}


@pytest.mark.parametrize("dtype", ["float64", "df32"])
@pytest.mark.parametrize("fmt", sorted(CASES))
def test_partition_matches_jax(fmt, dtype):
    gen, args, kw, N = CASES[fmt]
    t, j = _both(gen, *args, **kw)
    jd = "df32" if dtype == "df32" else np.dtype(dtype)
    tp = partition_csr(t, N, dtype=dtype, format=fmt)
    jp = j_partition(j, N, dtype=jd, format=fmt)
    assert_same_partition(tp, jp)
    assert tp.dtype == ("df32" if dtype == "df32" else torch.float64)
    if fmt == "window":
        assert tp.has_window and tp.has_ell
    if fmt == "butterfly":
        assert tp.has_bfly and not tp.has_ell


@pytest.mark.parametrize("N", [2, 4, 8])
@pytest.mark.parametrize("mode,offsets", [("halo", [1, -1, 9, -9]),
                                          ("gather", [1, -1, 70, -70])])
def test_dia_modes_uneven_n(mode, offsets, N):
    # n = 1003: identity rows pad it to a multiple of 8 N
    t, j = _both("banded_random", 1003, offsets, seed=5)
    tp = partition_csr(t, N, dtype=np.float32, format="dia")
    jp = j_partition(j, N, dtype=np.dtype(np.float32), format="dia")
    want = "gather" if max(abs(o) for o in offsets) > tp.n_loc else "halo"
    assert tp.dia_mode == want
    if mode == "halo":
        assert want == "halo"
    assert tp.n_global % (8 * N) == 0 and tp.n_logical == 1003
    assert_same_partition(tp, jp)


def test_hybrid_remainder_is_ell():
    # a band plus scattered stragglers: DIA part and ELL remainder
    t, j = _both("banded_random", 600, [1, -1, 5, -5], seed=7)
    rng = np.random.default_rng(0)
    extra_r = rng.integers(0, 600, 40)
    extra_c = rng.integers(0, 600, 40)

    def add(csr, mod):
        from scipy.sparse import coo_matrix
        m = coo_matrix((csr.val, (np.repeat(np.arange(600),
                                            np.diff(csr.ptr)), csr.col)),
                       shape=(600, 600)).tocsr()
        m = m + coo_matrix((np.full(40, 0.01), (extra_r, extra_c)),
                           shape=(600, 600)).tocsr()
        m.sort_indices()
        return mod.CSRMatrix(m.indptr.astype(np.int64),
                             m.indices.astype(np.int64), m.data,
                             (600, 600))
    import mpi_bicgstab_tpu.ops.sparse as js
    import mpi_bicgstab_tpu_torch.ops.sparse as ts
    tp = partition_csr(add(t, ts), 4, dtype=np.float64)
    jp = j_partition(add(j, js), 4, dtype=np.dtype(np.float64))
    assert tp.has_dia and tp.has_ell
    assert_same_partition(tp, jp)


@pytest.mark.parametrize("rb,P", [(32, 3072), (16, 5120)])
def test_butterfly_forced_geometry_matches_jax(rb, P):
    # a shard's row slab (rectangular: its rows x all columns) routed
    # under a forced (rb, P), as the partition harmonises its shards
    t, j = _both("random_diag_dominant", 4096, nnz_per_row=6, seed=1)
    rows = slice(0, 2048)

    def slab(csr, mod):
        lo, hi = csr.ptr[rows.start], csr.ptr[rows.stop]
        return mod.CSRMatrix(csr.ptr[:rows.stop + 1] - lo, csr.col[lo:hi],
                             csr.val[lo:hi], (2048, 4096))
    import mpi_bicgstab_tpu.ops.sparse as js
    import mpi_bicgstab_tpu_torch.ops.sparse as ts
    tb = butterfly_tables(slab(t, ts), seed=7, rb_force=rb, P_force=P)
    jb = j_build_bf(slab(j, js), seed=7, rb_force=rb, P_force=P)
    assert (tb["rb"], tb["P"]) == (rb, P) == (jb.rb, jb.P)
    for k in ("k1_src", "k1_sub", "k1_lane", "k2_sub", "k2_lane", "k3_sub",
              "k3_lane", "k3_vals", "tail_rows", "tail_cols", "tail_vals"):
        np.testing.assert_array_equal(tb[k], np.asarray(getattr(jb, k)),
                                      err_msg=k)


def test_partition_layout_cache_roundtrip(tmp_path):
    t, _ = _both("clustered_random", 4096)
    a = partition_csr(t, 2, dtype="df32", cache_dir=str(tmp_path))
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].name.startswith("torch_layout_")
    b = partition_csr(t, 2, dtype="df32", cache_dir=str(tmp_path))
    assert b.has_window and b.win_tail_counts == a.win_tail_counts
    for k in META:
        assert getattr(a, k) == getattr(b, k), k
    for k in ARRAYS:
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        for g, w in zip(_halves(x) if x is not None else (),
                        _halves(y) if y is not None else ()):
            assert torch.equal(g, w), k
    # another option is another key: a second entry
    partition_csr(t, 2, dtype="df32", cache_dir=str(tmp_path), align=16)
    assert len(list(tmp_path.iterdir())) == 2


def test_shard_blocks_are_the_rank_slices():
    t, _ = _both("banded_random", 1000, [1, -1, 9, -9], seed=0)
    part = partition_csr(t, 4, dtype=np.float64, format="ell")
    sh = part.shard(2, "cpu")
    s = slice(2 * part.n_loc, 3 * part.n_loc)
    assert torch.equal(sh.blocks[0].cols, part.diag_cols[:, s])
    assert sh.blocks[1].n_cols == part.n_global and sh.dtype == torch.float64
    with pytest.raises(ValueError, match="outside"):
        part.shard(4, "cpu")


def test_ell_spmv_shifted_and_nnz_stored_match_jax():
    t, j = _both("banded_random", 300, [1, -1, 4, -4], seed=3)
    te = t_csr_to_ell(t, width=3, device="cpu")
    je = j_csr_to_ell(j, width=3)
    assert te.nnz_stored == je.nnz_stored
    x = np.random.default_rng(1).standard_normal(300)
    got = t_ell_shifted(te, torch.as_tensor(x), 0.25).numpy()
    want = np.asarray(j_ell_shifted(je, jnp.asarray(x), 0.25))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)


def test_dia_pad_matches_jax():
    t, j = _both("banded_random", 200, [2, -7, 11], seed=4)
    td, _ = t_csr_to_dia(t, (2, -7, 11), device="cpu")
    jd, _ = j_csr_to_dia(j, (2, -7, 11))
    assert td.pad == jd.pad == (7, 11)


def test_ops_reexports_match_jax():
    names = {n for n in vars(jops) if not n.startswith("_")
             and not isinstance(getattr(jops, n), type(jops))}
    assert names <= set(vars(tops)), names - set(vars(tops))
