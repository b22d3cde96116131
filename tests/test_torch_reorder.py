"""Port vs JAX package: the host preprocessing of an unstructured .mtx,
RCM reordering (ops/reorder.py) and Jacobi scaling (ops/scale.py), in the
library and through the CLI's --reorder, --scale, --rhs, --x0 and
--write-solution.

Arrays and permutations: equal (np.array_equal). CLI solves: the same
route (DIA/hybrid after the reorder), total_iter within +-2 of the JAX
CLI's, and the written solutions (original row order and scale) within
1e-10 of JAX's.
"""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu.cli as jcli
import mpi_bicgstab_tpu.models.generators as jgen
import mpi_bicgstab_tpu.models.problem as jprob
import mpi_bicgstab_tpu.ops.dia as jdia
import mpi_bicgstab_tpu.ops.reorder as jre
import mpi_bicgstab_tpu.ops.scale as jsc
import mpi_bicgstab_tpu.ops.sparse as jsparse
import mpi_bicgstab_tpu_torch.models.generators as tgen
import mpi_bicgstab_tpu_torch.models.problem as tprob
import mpi_bicgstab_tpu_torch.ops.reorder as tre
import mpi_bicgstab_tpu_torch.ops.scale as tsc
import mpi_bicgstab_tpu_torch.ops.sparse as tsparse
from mpi_bicgstab_tpu.io.mmio import write_matrix_market
from mpi_bicgstab_tpu_torch import cli

torch.set_num_threads(1)


def _same_csr(a, b):
    assert a.shape == b.shape
    for k in ("ptr", "col", "val"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def _shuffled_banded(n=512, offsets=(1, -1, 5, -5), seed=7):
    """tests/test_reorder.py's fixture in each package: a banded matrix
    in a scrambled row/column order. Returns ((port, JAX) banded,
    (port, JAX) shuffled)."""
    shuffle = np.random.default_rng(seed).permutation(n)
    banded = (tgen.banded_random(n, list(offsets), seed=3),
              jgen.banded_random(n, list(offsets), seed=3))
    return banded, (tre.permute_csr(banded[0], shuffle),
                    jre.permute_csr(banded[1], shuffle))


def _random(n=256, k=6, seed=2):
    """A diagonally dominant matrix with random columns (JAX's
    random_diag_dominant kind, made here with NumPy): RCM cannot band
    it."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.repeat(np.arange(n), k), np.arange(n)])
    cols = np.concatenate([rng.integers(0, n, n * k), np.arange(n)])
    vals = np.concatenate([rng.uniform(-1, 1, n * k), np.full(n, 8.0)])
    return tuple(m.coo_to_csr(m.COOMatrix(rows, cols, vals, (n, n)),
                              sum_duplicates=True)
                 for m in (tsparse, jsparse))


def test_rcm_orderings_equal_jax():
    _, (t, j) = _shuffled_banded()
    perm = tre.rcm_ordering(t)
    np.testing.assert_array_equal(perm, jre.rcm_ordering(j))
    np.testing.assert_array_equal(tre._rcm_bfs(t), jre._rcm_bfs(j))
    assert perm.dtype == np.int64 and sorted(perm) == list(range(512))
    assert tre.bandwidth(t, perm) == jre.bandwidth(j, perm)
    assert tre.bandwidth(t) == jre.bandwidth(j) > 50 * 5


def test_permute_csr_and_vectors_equal_jax():
    _, (t, j) = _shuffled_banded(n=300, seed=9)
    perm = np.random.default_rng(1).permutation(300)
    _same_csr(tre.permute_csr(t, perm), jre.permute_csr(j, perm))
    v = np.random.default_rng(2).standard_normal(300)
    np.testing.assert_array_equal(tre.permute_vector(v, perm),
                                  jre.permute_vector(v, perm))
    np.testing.assert_array_equal(tre.unpermute_vector(v, perm),
                                  jre.unpermute_vector(v, perm))
    np.testing.assert_array_equal(
        tre.unpermute_vector(tre.permute_vector(v, perm), perm), v)


@pytest.mark.parametrize("mode", ["auto", "rcm", "none"])
@pytest.mark.parametrize("kind", ["shuffled", "banded", "random"])
def test_maybe_reorder_decides_as_jax(kind, mode):
    """Accepted on the shuffled band; skipped by 'auto' where the matrix
    already sits on diagonals or RCM cannot put it there."""
    banded, shuffled = _shuffled_banded()
    t, j = {"shuffled": shuffled, "banded": banded,
            "random": _random()}[kind]
    ct, pt = tre.maybe_reorder(t, mode)
    cj, pj = jre.maybe_reorder(j, mode)
    assert (pt is None) == (pj is None)
    if pt is not None:
        np.testing.assert_array_equal(pt, pj)
    _same_csr(ct, cj)
    applied = mode == "rcm" or (mode == "auto" and kind == "shuffled")
    assert (pt is not None) == applied
    if pt is None:
        assert ct is t
    with pytest.raises(ValueError, match="unknown reorder mode"):
        tre.maybe_reorder(t, "bogus")


def _badly_scaled(n=256, seed=12):
    """tests/test_scale.py's kind: a dominant band whose row and column
    magnitudes span 1e-4..1e4."""
    s = 10.0 ** np.random.default_rng(seed).uniform(-4, 4, n)
    out = []
    for gen, sparse in ((tgen, tsparse), (jgen, jsparse)):
        csr = gen.banded_random(n, [1, -1, 9, -9], seed=3)
        rows = np.repeat(np.arange(n), np.diff(csr.ptr))
        out.append(sparse.CSRMatrix(csr.ptr, csr.col,
                                    csr.val * s[rows] * s[csr.col],
                                    csr.shape))
    return out


def test_jacobi_scale_equal_jax():
    t, j = _badly_scaled()
    (st, dt), (sj, dj) = tsc.jacobi_scale(t), jsc.jacobi_scale(j)
    _same_csr(st, sj)
    np.testing.assert_array_equal(dt, dj)
    v = np.random.default_rng(3).standard_normal(t.nrows)
    np.testing.assert_array_equal(tsc.scale_rhs(v, dt),
                                  jsc.scale_rhs(v, dj))
    np.testing.assert_array_equal(tsc.unscale_solution(v, dt),
                                  jsc.unscale_solution(v, dj))
    # a row without a structural diagonal keeps scale 1
    rows = np.repeat(np.arange(t.nrows), np.diff(t.ptr))
    keep = ~((rows == 5) & (t.col == 5))
    hole = tsparse.coo_to_csr(tsparse.COOMatrix(rows[keep], t.col[keep],
                                                t.val[keep], t.shape))
    assert tsc.jacobi_scale(hole)[1][5] == 1.0


def test_build_problem_reorders_and_unpermutes_as_jax():
    _, (t, j) = _shuffled_banded()
    pt = tprob.build_problem(t, reorder="auto", device="cpu")
    pj = jprob.build_problem(j, reorder="auto")
    np.testing.assert_array_equal(pt.perm, pj.perm)
    assert type(pt.A).__name__ == type(pj.A).__name__
    assert type(pt.A).__name__ in ("DiaMatrix", "HybridMatrix")
    assert tprob.build_problem(t, format="ell", device="cpu").perm is None
    X = np.random.default_rng(4).standard_normal((3, pt.n))
    np.testing.assert_array_equal(pt.unpermute(X), pj.unpermute(X))
    np.testing.assert_array_equal(pt.unpermute(X[0]), pj.unpermute(X[0]))


def _jax_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = jcli.main([*argv, "--platform", "cpu", "--json"])
    return code, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture
def shuffled_mtx(tmp_path):
    """The shuffled band as an .mtx (p.mtx) and badly scaled (s.mtx), with
    a right-hand side and a warm start in its (scrambled) row order."""
    n = 1024
    _, (_, j) = _shuffled_banded(n=n, seed=11)
    s = 10.0 ** np.random.default_rng(5).uniform(-2, 2, n)
    rows = np.repeat(np.arange(n), np.diff(j.ptr))
    write_matrix_market(str(tmp_path / "p.mtx"), rows, j.col, j.val, (n, n))
    write_matrix_market(str(tmp_path / "s.mtx"), rows, j.col,
                        j.val * s[rows] * s[j.col], (n, n))
    rng = np.random.default_rng(6)
    np.save(tmp_path / "b.npy", rng.standard_normal(n))
    np.save(tmp_path / "x0.npy", 0.1 * rng.standard_normal(n))
    return tmp_path


def test_cli_reorder_scale_rhs_x0_match_jax(shuffled_mtx):
    """The CLI defaults (--reorder auto) on a shuffled, badly scaled
    banded .mtx with --scale jacobi, --rhs, --x0 and --write-solution:
    both CLIs reorder, take the DIA route and write the same solution in
    the original order and scale."""
    d = shuffled_mtx
    base = ["solve", "--matrix", str(d / "s.mtx"), "--tol", "1e-12",
            "--scale", "jacobi", "--rhs", str(d / "b.npy"), "--x0",
            str(d / "x0.npy")]
    jcode, want = _jax_cli([*base, "--write-solution", str(d / "xj.npy")])
    got, res = cli.run_solve(cli.build_parser().parse_args(
        [*base, "--write-solution", str(d / "xt.npy"), "--device", "cpu"]))
    assert jcode == 0 and want["converged"] and got["converged"]
    assert got["reordered"] is want["reordered"] is True
    assert got["scaled"] is want["scaled"] is True
    assert got["layout"] in ("DiaMatrix", "HybridMatrix")
    # JAX's 'auto' routes the reordered, scaled matrix to DIA/hybrid too
    csr, perm = jre.maybe_reorder(jsparse.load_csr(str(d / "s.mtx")), "auto")
    assert perm is not None
    assert jdia.analyze_diagonals(jsc.jacobi_scale(csr)[0])[1] >= 0.5
    assert abs(got["total_iter"] - want["total_iter"]) <= 2
    xt, xj = np.load(d / "xt.npy"), np.load(d / "xj.npy")
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-10 * np.abs(xj).max())
    # and it solves the original system
    A = tsparse.load_csr(str(d / "s.mtx"))
    b = np.load(d / "b.npy")
    assert np.linalg.norm(A.matvec(xt) - b) <= 1e-8 * np.linalg.norm(b)


def test_cli_reorder_flags_rhs_batch_and_shifted(shuffled_mtx):
    """--reorder none keeps the scrambled order, where 'auto' finds no
    diagonals and takes windowed-ELL (one 1024-column window holds every
    column); --rhs-batch and solve-shifted permute and unpermute as the
    JAX CLI does."""
    d = shuffled_mtx
    mtx = str(d / "p.mtx")
    got, _ = cli.run_solve(cli.build_parser().parse_args(
        ["solve", "--matrix", mtx, "--reorder", "none", "--max-iter", "2",
         "--device", "cpu"]))
    assert got["layout"] == "WindowEllMatrix" and not got["reordered"]
    A = tsparse.load_csr(mtx)
    B = np.stack([A.matvec(np.ones(A.nrows)), np.load(d / "b.npy")])
    np.save(d / "B.npy", B)
    base = ["solve", "--matrix", mtx, "--rhs-batch", str(d / "B.npy"),
            "--tol", "1e-12"]
    jcode, want = _jax_cli([*base, "--write-solution", str(d / "Xj.npy")])
    got, _ = cli.run_solve(cli.build_parser().parse_args(
        [*base, "--write-solution", str(d / "Xt.npy"), "--device", "cpu"]))
    assert jcode == 0 and all(got["converged"])
    assert all(abs(a - b) <= 2 for a, b in zip(got["n_iter"],
                                               want["n_iter"]))
    Xt, Xj = np.load(d / "Xt.npy"), np.load(d / "Xj.npy")
    np.testing.assert_allclose(Xt, Xj, rtol=0, atol=1e-9)
    np.testing.assert_allclose(Xt[0], 1.0, atol=1e-9)
    base = ["solve-shifted", "--matrix", mtx, "--sigma-len", "4", "--seed",
            "1", "--tol", "1e-10"]
    jcode, want = _jax_cli([*base, "--write-solution", str(d / "Sj.npy")])
    rows, _ = cli.run_solve_shifted(cli.build_parser().parse_args(
        [*base, "--write-solution", str(d / "St.npy"), "--device", "cpu"]))
    assert jcode == 0 and rows[0]["all_converged"]
    assert abs(rows[0]["total_iter"] - want["total_iter"]) <= 2
    np.testing.assert_allclose(np.load(d / "St.npy"), np.load(d / "Sj.npy"),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("argv,match", [
    (["solve", "--precond", "cheby:4"], "--precond cannot be combined"),
    (["solve", "--rhs-batch", "B.npy"], "--rhs-batch cannot be combined"),
    (["solve-shifted", "--sigma-len", "4", "--seed", "1"],
     "not valid for the shifted family"),
])
def test_x0_refusals_match_jax(shuffled_mtx, argv, match):
    d = shuffled_mtx
    mtx = str(d / "s.mtx")
    A = tsparse.load_csr(mtx)
    np.save(d / "B.npy", np.stack([A.matvec(np.ones(A.nrows))] * 2))
    argv = [a.replace("B.npy", str(d / "B.npy")) for a in argv]
    full = [argv[0], "--matrix", mtx, *argv[1:], "--x0", str(d / "x0.npy")]
    with pytest.raises(SystemExit, match=match):
        cli.main([*full, "--device", "cpu"])
    with pytest.raises(SystemExit) as ex:
        jcli.main([*full, "--platform", "cpu"])
    assert ex.value.code not in (None, 0)
