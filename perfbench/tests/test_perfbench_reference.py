"""The reference's frozen generators give the program's matrices bit for
bit, and its operator is the program's host SpMV to rounding."""
import numpy as np
import pytest
import torch

from mpi_bicgstab_tpu_torch.models import generators as program
from perfbench.reference import generators as ref
from perfbench.reference.operator import DiaOperator, relres


def _same_csr(a, b):
    ptr, col, val = a
    assert np.array_equal(ptr, b.ptr)
    assert np.array_equal(col, b.col)
    assert np.array_equal(val.view(np.uint64), b.val.view(np.uint64))


@pytest.mark.parametrize("n,seed", [(1000, 0), (4096, 0), (4096, 3),
                                    (2197, 2**31 + 5)])
def test_transport_hard_bit_equal(n, seed):
    _same_csr(ref.dia_to_csr(*ref.transport_hard(n, seed=seed)),
              program.transport_hard(n, seed=seed))


@pytest.mark.parametrize("n,seed", [(512, 0), (4096, 0), (4096, 7),
                                    (5000, 2**31 + 5)])
def test_transport_like_bit_equal(n, seed):
    _same_csr(ref.dia_to_csr(*ref.transport_like(n, seed=seed)),
              program.transport_like(n, seed=seed))


@pytest.mark.parametrize("gen", ["transport_hard", "transport_like"])
def test_operator_is_the_matrix(gen):
    csr = getattr(program, gen)(1000, seed=1)
    A = DiaOperator.from_generator(ref.GENERATORS[gen], n=1000, seed=1)
    assert A.band_entries == csr.nnz
    x = np.random.default_rng(0).uniform(0.5, 1.5, (3, A.n))
    y = A.matvec(torch.from_numpy(x)).numpy()
    for j in range(3):
        want = csr.matvec(x[j])
        np.testing.assert_allclose(y[j], want, rtol=1e-13,
                                   atol=1e-13 * np.abs(want).max())


def test_relres_of_the_exact_solution_and_of_a_shift():
    A = DiaOperator.from_generator(ref.transport_like, n=512, seed=0)
    x = torch.ones(2, A.n, dtype=torch.float64)
    sig = torch.tensor([0.0, 0.5], dtype=torch.float64)
    b = A.matvec(x[0]) + 0.5 * x[0]
    r = relres(A, x, b, sig)
    assert r[1] < 1e-15                 # (A + 0.5 I) 1 = b exactly
    assert abs(float(r[0]) - float(torch.linalg.vector_norm(0.5 * x[0])
                                   / torch.linalg.vector_norm(b))) < 1e-15


def test_full_size_shapes_of_the_configurations():
    """The configurations' stated rows, diagonals and band entries are
    the generators' at n = 1,602,112 (offsets only, no values drawn)."""
    import json
    from pathlib import Path
    here = Path(__file__).resolve().parents[1] / "configs"
    for name in ("transport-hard", "transport-shifted512"):
        c = json.loads((here / f"{name}.json").read_text())
        n = c["n"]
        m = int(round(n ** (1 / 3)))
        if c["generator"] == "transport_hard":
            N = m ** 3
            offs = [0] + [s * o for o in (1, m, m * m) for s in (1, -1, 2, -2)]
        else:
            N = n
            offs = [0, 1, -1, 2, -2, m, -m, m + 1, -(m + 1), m * m, -(m * m),
                    m * m + m, -(m * m + m), m * m + m + 1, -(m * m + m + 1)]
        assert (N, len(offs)) == (c["rows"], c["diagonals"])
        assert sum(N - abs(o) for o in offs) == c["band_entries"]
