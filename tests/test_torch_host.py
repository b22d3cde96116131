"""Port vs JAX package: host-side data (generators, padding, b = A*1,
Matrix Market and .npz I/O). Tolerance: EQUAL arrays — both packages run
the same NumPy arithmetic in the same order."""
import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.io.mmio as jmmio
import mpi_bicgstab_tpu.models.generators as jgen
import mpi_bicgstab_tpu.models.problem as jprob
import mpi_bicgstab_tpu.ops.sparse as jsparse
import mpi_bicgstab_tpu_torch.io.mmio as tmmio
import mpi_bicgstab_tpu_torch.models.generators as tgen
import mpi_bicgstab_tpu_torch.models.problem as tprob
import mpi_bicgstab_tpu_torch.ops.sparse as tsparse

torch.set_num_threads(1)


def _assert_csr_equal(a, b):
    assert tuple(a.shape) == tuple(b.shape)
    np.testing.assert_array_equal(a.ptr, b.ptr)
    np.testing.assert_array_equal(a.col, b.col)
    np.testing.assert_array_equal(a.val, b.val)


GENERATORS = [
    ("poisson2d", (24,), {}),
    ("poisson3d", (9,), {}),
    ("banded_random", (3000, [1, -1, 7, -7, 200, -200]), {"seed": 3}),
    ("banded_random", (500, [2, 2, -3]), {"seed": 4}),   # duplicate offsets
    ("transport_like", (4096,), {"seed": 1}),
    ("transport_hard", (4096,), {"seed": 2}),
    ("_dia_to_csr", (6, [0, 1, -2], [np.arange(6.0), 2.0, -1.0]), {}),
]


@pytest.mark.parametrize("name,args,kw", GENERATORS,
                         ids=[g[0] + str(i) for i, g in enumerate(GENERATORS)])
def test_generators_bit_identical(name, args, kw):
    _assert_csr_equal(getattr(tgen, name)(*args, **kw),
                      getattr(jgen, name)(*args, **kw))


@pytest.mark.parametrize("multiple", [1, 8, 1000])
def test_pad_csr_identity_equal(multiple):
    csr_j = jgen.banded_random(777, [1, -1, 30, -30], seed=5)
    csr_t = tgen.banded_random(777, [1, -1, 30, -30], seed=5)
    _assert_csr_equal(tprob.pad_csr_identity(csr_t, multiple),
                      jprob.pad_csr_identity(csr_j, multiple))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_build_problem_rhs_equal(dtype):
    import jax.numpy as jnp
    csr_j = jgen.transport_like(3000, seed=2)
    csr_t = tgen.transport_like(3000, seed=2)
    pj = jprob.build_problem(csr_j, dtype=getattr(jnp, dtype), multiple=8)
    pt = tprob.build_problem(csr_t, dtype=dtype, multiple=8, device="cpu")
    assert pt.n == pj.n and pt.n_logical == pj.n_logical
    assert pt.b.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(pt.b.numpy(), np.asarray(pj.b))
    np.testing.assert_array_equal(pt.exact_solution(), pj.exact_solution())
    assert not pt.x0.any()


def test_matrix_market_round_trip(tmp_path):
    csr = jgen.banded_random(400, [1, -1, 17, -17], seed=6)
    rows = np.repeat(np.arange(csr.nrows), csr.row_lengths)
    jpath = str(tmp_path / "j.mtx")
    jmmio.write_matrix_market(jpath, rows, csr.col, csr.val, csr.shape,
                              comment="written by the JAX package")
    got = tmmio.read_matrix_market(jpath)
    want = jmmio.read_matrix_market(jpath, use_native=False)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]
    _assert_csr_equal(tsparse.load_csr(jpath), jsparse.load_csr(jpath))
    # and back: the port's writer, the JAX reader
    tpath = str(tmp_path / "t.mtx")
    tmmio.write_matrix_market(tpath, *got)
    for g, w in zip(jmmio.read_matrix_market(tpath, use_native=False)[:3],
                    want[:3]):
        np.testing.assert_array_equal(g, w)


def test_matrix_market_symmetric_pattern_and_npz(tmp_path):
    p = tmp_path / "s.mtx"
    p.write_text("%%MatrixMarket matrix coordinate pattern symmetric\n"
                 "% comment\n4 4 5\n1 1\n2 1\n3 2\n4 4\n4 3\n")
    for g, w in zip(tmmio.read_matrix_market(str(p))[:3],
                    jmmio.read_matrix_market(str(p), use_native=False)[:3]):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        tmmio.read_matrix_market(str(p), expand_symmetric=False)
    csr = jgen.poisson2d(10)
    npz = str(tmp_path / "a.npz")
    jsparse.save_csr(npz, csr)
    _assert_csr_equal(tsparse.load_csr(npz), jsparse.load_csr(npz))
