"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here carries the `cuda` marker and skips from inside its body
when no card is present. On the machine with the card (which has no
JAX, so this file imports none and is run without the JAX-side
conftest):

    python -m pytest tests/test_torch_kernels.py --noconftest -m cuda

The plain twins themselves are held to the JAX package in the CPU tests
(test_torch_fused_classic.py, test_torch_fused_ca.py,
test_torch_fused_pipe.py, test_torch_fused_classic_df.py,
test_torch_fused_ca_df.py, test_torch_fused_pipe_df.py,
test_torch_layout.py, test_torch_shift_update.py, test_torch_cheby.py,
test_torch_pipe_df_bodies.py, test_torch_window.py,
test_torch_butterfly.py). The one host-side test here
(test_df32_host_side_end_to_end) needs no card and runs anywhere.

Tolerances: float32 vectors rtol 1e-5 / atol 1e-4 and dots rtol 1e-4
(the kernels contract multiply-adds into FMAs and sum the dots in
another order than PyTorch; the CA and pipe kernels' dots also take
atol 1e-3, as in the CPU tests, because a dot of two independent random
vectors can cancel to ~1 while its rounding follows the terms); float64
rtol 1e-12 with atol 1e-12 times the output's largest entry (rows whose
terms cancel keep the rounding of the largest terms). Double-float (DF)
kernels: output vectors and folded scalars bit-equal to the twin's, each
dot within 1e-12 sum |u_i v_i| (the kernels sum their compensated
partials in another order). The DF shift update: the updated state
bit-equal to the twin's, frozen rows bit-unchanged. Shifted solves on the
card against the CPU: n_iter within 2, the same final seed, solutions
within 1e-8 (1e-3 in float32). The float32 Chebyshev chain: within 2e-6
of the twin's largest entry (the JAX package's bar, tests/test_cheby.py);
the DF chain and the DF pipelined bodies as the other DF kernels. The
windowed-ELL and butterfly kernels: bit-equal to their twins (unfused
products and sums in the twins' order; the butterfly's routing stages
move bits).
"""
import contextlib
import io

import numpy as np
import pytest
import torch

from mpi_bicgstab_tpu_torch import cli, convert
from mpi_bicgstab_tpu_torch.api import solve, solve_shifted
from mpi_bicgstab_tpu_torch.models.generators import banded_random
from mpi_bicgstab_tpu_torch.models.problem import build_problem
from mpi_bicgstab_tpu_torch.ops import cuda_fused_ca as fca
from mpi_bicgstab_tpu_torch.ops import cuda_fused_ca_df as fcadf
from mpi_bicgstab_tpu_torch.ops import cuda_fused_classic as fcl
from mpi_bicgstab_tpu_torch.ops import cuda_fused_classic_df as fcldf
from mpi_bicgstab_tpu_torch.ops import cuda_fused_pipe as fpipe
from mpi_bicgstab_tpu_torch.ops import cuda_fused_pipe_df as fpipedf
from mpi_bicgstab_tpu_torch.ops import cuda_shift_update as csu
from mpi_bicgstab_tpu_torch.ops import cuda_spmv
from mpi_bicgstab_tpu_torch.ops.dia import csr_to_dia
from mpi_bicgstab_tpu_torch.ops.layout import build_operator, spmv
from mpi_bicgstab_tpu_torch.ops.precision import (DF, df_div, df_from_f64,
                                                  df_mul, df_to_f64, is_df)
from mpi_bicgstab_tpu_torch.solvers.base import fold_beta_alpha
from mpi_bicgstab_tpu_torch.utils.config import ShiftedConfig, SolverConfig

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

CASES = [(5000, [1, -1, 40, -40, 129, -129]),
         (16384, [1, -1, 9000, -9000]),
         (100, [1, -1, 99, -99, 150])]       # n < one block; offset > n


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _band(n, offsets, dtype, dev, seed=0):
    """DIA band on exactly `offsets` (plus 0); an offset beyond n is a
    diagonal of zeros whose every neighbour is out of range."""
    csr = banded_random(n, [o for o in offsets if abs(o) < n], seed=seed)
    A, rem = csr_to_dia(csr, sorted({0, *offsets}), dtype=dtype,
                        device=dev)
    assert rem is None
    return A


def _vecs(n, k, dev, dtype=torch.float32, seed=1):
    g = np.random.default_rng(seed)
    return [torch.as_tensor(g.standard_normal(n), dtype=dtype, device=dev)
            for _ in range(k)]


def _close(got, want, dot_atol=0.0):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g.dim() == 0:
            torch.testing.assert_close(g, w, rtol=1e-4, atol=dot_atol)
        elif g.dtype == torch.float64:
            torch.testing.assert_close(g, w, rtol=1e-12,
                                       atol=1e-12 * float(w.abs().max()))
        else:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,offsets", CASES)
def test_dia_spmv_kernel_matches_plain(n, offsets, dtype):
    dev = _card()
    A = _band(n, offsets, dtype, dev)
    (x,) = _vecs(n, 1, dev, dtype)
    before = cuda_spmv.dia_spmv.launches
    y = cuda_spmv.dia_spmv(A.vals, A.offsets, x)
    torch.cuda.synchronize()
    assert cuda_spmv.dia_spmv.launches == before + 1
    _close([y], [cuda_spmv.dia_spmv_plain(A.vals, A.offsets, x)])


@pytest.mark.parametrize("n,offsets", CASES)
def test_fused_kernels_match_plain(n, offsets):
    dev = _card()
    A = _band(n, offsets, torch.float32, dev)
    r, p, s, rh, x, q, y = _vecs(n, 7, dev)
    a, b, w = (torch.tensor(v, device=dev) for v in (0.7, 0.3, 0.2))
    v, o = A.vals, A.offsets
    _close(fcl.fused_k1(v, r, p, s, rh, (b, w), o),
           fcl.fused_k1_plain(v, r, p, s, rh, (b, w), o))
    _close(fcl.fused_k2(v, r, s, (a,), o),
           fcl.fused_k2_plain(v, r, s, (a,), o))
    _close(fcl.fused_k3(x, p, q, y, rh, (a, w)),
           fcl.fused_k3_plain(x, p, q, y, rh, (a, w)))


@pytest.mark.parametrize("n,offsets", CASES)
def test_ca_and_pipe_kernels_match_plain(n, offsets):
    dev = _card()
    A = _band(n, offsets, torch.float32, dev)
    r, p, s, w, z, x, q, y, rh = _vecs(n, 9, dev)
    a, b, om = (torch.tensor(v, device=dev) for v in (0.7, 0.3, 0.2))
    v, o = A.vals, A.offsets
    for kern, plain, args in (
            (fca.fused_ca_k1, fca.fused_ca_k1_plain,
             (v, r, p, s, w, z, (a, b, om), o)),
            (fca.fused_ca_k2, fca.fused_ca_k2_plain,
             (v, q, y, x, p, rh, s, z, (a, om), o)),
            (fpipe.fused_phase_a, fpipe.fused_phase_a_plain,
             (v, z, r, p, s, w, x, (a, b, om), o)),
            (fpipe.fused_phase_b, fpipe.fused_phase_b_plain,
             (v, w, x, p, q, y, rh, s, z, (a, om), o))):
        before = kern.launches
        got = kern(*args)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        _close(got, plain(*args), dot_atol=1e-3)


def test_fused_dots_are_deterministic():
    dev = _card()
    A = _band(16384, [1, -1, 40, -40], torch.float32, dev)
    r, p, s, rh = _vecs(16384, 4, dev)
    z = torch.zeros((), device=dev)
    runs = [fcl.fused_k1(A.vals, r, p, s, rh, (z + 0.3, z + 0.2),
                         A.offsets) for _ in range(3)]
    for other in runs[1:]:
        for g, w in zip(other, runs[0]):
            assert torch.equal(g, w)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("float64", 1e-10)])
def test_solve_on_card_matches_cpu(dtype, tol):
    dev = _card()
    csr = banded_random(20000, [1, -1, 40, -40, 2000, -2000], seed=3)
    cfg = SolverConfig(tol=tol, max_iter=300, dtype=dtype)
    res = {}
    for d in (dev, "cpu"):
        prob = build_problem(csr, dtype=dtype, device=d)
        res[d] = solve(prob.A, prob.b, cfg=cfg)
    assert bool(res[dev].converged) and bool(res["cpu"].converged)
    assert abs(res[dev].n_iter - res["cpu"].n_iter) <= 2
    err = float((res[dev].x.double().cpu() - 1.0).abs().max())
    assert err < (1e-3 if dtype == "float32" else 1e-6), err


def test_fused_route_launches_each_pass_once_per_iteration():
    dev = _card()
    prob = build_problem(banded_random(8192, [1, -1, 40, -40], seed=12),
                         dtype="float32", device=dev)
    for fn in (fcl.fused_k1, fcl.fused_k2, fcl.fused_k3,
               cuda_spmv.dia_spmv):
        fn.launches = 0
    res = solve(prob.A, prob.b,
                cfg=SolverConfig(tol=0.0, max_iter=25, dtype="float32"))
    assert res.n_iter == 25
    assert (fcl.fused_k1.launches, fcl.fused_k2.launches,
            fcl.fused_k3.launches) == (25, 25, 25)
    assert cuda_spmv.dia_spmv.launches == 2     # r0 and the true residual


@pytest.mark.parametrize("method", ["ca_bicgstab", "pipe_bicgstab",
                                    "pipe_bicgstab_rr", "bicgstab_l2"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("float64", 1e-10)])
def test_family_solve_on_card_matches_cpu(method, dtype, tol):
    dev = _card()
    csr = banded_random(20000, [1, -1, 40, -40, 2000, -2000], seed=3)
    cfg = SolverConfig(tol=tol, max_iter=300, krr=4, nrr=2, dtype=dtype)
    res = {}
    for d in (dev, "cpu"):
        prob = build_problem(csr, dtype=dtype, device=d)
        res[d] = solve(prob.A, prob.b, method=method, cfg=cfg)
    assert bool(res[dev].converged) and bool(res["cpu"].converged)
    assert abs(res[dev].n_iter - res["cpu"].n_iter) <= 4
    err = float((res[dev].x.double().cpu() - 1.0).abs().max())
    assert err < (1e-3 if dtype == "float32" else 1e-6), err


@pytest.mark.parametrize("method,kernels,spmvs", [
    ("ca_bicgstab", ("fused_ca_k1", "fused_ca_k2"), 3),     # r0, w0, true
    ("pipe_bicgstab", ("fused_phase_a", "fused_phase_b"), 4),   # + t0
    # krr 5, nrr 2: iterations 5 and 10 replace, 6 SpMVs each
    ("pipe_bicgstab_rr", ("fused_phase_a", "fused_phase_b"), 4 + 12),
])
def test_ca_and_pipe_routes_launch_their_kernels(method, kernels, spmvs):
    dev = _card()
    prob = build_problem(banded_random(8192, [1, -1, 40, -40], seed=12),
                         dtype="float32", device=dev)
    fns = {"fused_ca_k1": fca.fused_ca_k1, "fused_ca_k2": fca.fused_ca_k2,
           "fused_phase_a": fpipe.fused_phase_a,
           "fused_phase_b": fpipe.fused_phase_b,
           "fused_k1": fcl.fused_k1, "dia_spmv": cuda_spmv.dia_spmv}
    for fn in fns.values():
        fn.launches = 0
    res = solve(prob.A, prob.b, method=method, cfg=SolverConfig(
        tol=0.0, max_iter=25, krr=5, nrr=2, dtype="float32"))
    assert res.n_iter == 25
    per_iter = 23 if method == "pipe_bicgstab_rr" else 25
    got = {k: fn.launches for k, fn in fns.items()}
    want = {k: (per_iter if k in kernels else 0) for k in fns}
    want["dia_spmv"] = spmvs
    assert got == want


@pytest.mark.parametrize("method", ["bicgstab", "ca_bicgstab",
                                    "pipe_bicgstab", "pipe_bicgstab_rr",
                                    "bicgstab_l2"])
def test_tol0_solve_replays_as_a_cuda_graph(method):
    """A tol=0 solve never synchronises with the host, so it can be
    captured whole (benchmarks.runner.bench_iteration(graph=True)); the
    replay gives the eager run's bits."""
    dev = _card()
    prob = build_problem(banded_random(8192, [1, -1, 40, -40], seed=12),
                         dtype="float32", device=dev)
    cfg = SolverConfig(tol=0.0, max_iter=10, krr=4, nrr=2, dtype="float32")
    eager = solve(prob.A, prob.b, method=method, cfg=cfg)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        solve(prob.A, prob.b, method=method, cfg=cfg)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        res = solve(prob.A, prob.b, method=method, cfg=cfg)
    g.replay()
    torch.cuda.synchronize()
    assert res.n_iter == 10
    assert torch.equal(res.x, eager.x)
    # BiCGStab(l)'s history is NaN between its slots
    torch.testing.assert_close(res.history, eager.history, rtol=0, atol=0,
                               equal_nan=True)


def test_wrappers_raise_instead_of_falling_back():
    dev = _card()
    A = _band(4096, [1, -1, 64, -64], torch.float32, dev)
    (x,) = _vecs(4096, 1, dev)
    with pytest.raises(TypeError):         # dtype the kernel does not take
        cuda_spmv.dia_spmv(A.vals, A.offsets, x.half())
    with pytest.raises(TypeError):         # vals and x of different dtypes
        cuda_spmv.dia_spmv(A.vals, A.offsets, x.double())
    with pytest.raises(ValueError):        # x on the card, vals not
        cuda_spmv.dia_spmv(A.vals.cpu(), A.offsets, x)
    with pytest.raises(ValueError):        # not contiguous
        cuda_spmv.dia_spmv(A.vals, A.offsets,
                           torch.stack([x, x], 1)[:, 0])
    with pytest.raises(ValueError):        # band of the wrong width
        cuda_spmv.dia_spmv(A.vals[:, :100], A.offsets, x)
    z = torch.zeros((), device=dev)
    with pytest.raises(ValueError):        # scalar on the CPU
        fcl.fused_k2(A.vals, x, x, (torch.zeros(()),), A.offsets)
    with pytest.raises(ValueError):        # missing scalar
        fcl.fused_k3(x, x, x, x, x, (z,))
    with pytest.raises(ValueError):        # scalar on the CPU
        fca.fused_ca_k1(A.vals, x, x, x, x, x, (z, z, torch.zeros(())),
                        A.offsets)
    with pytest.raises(TypeError):         # float64 vector
        fca.fused_ca_k2(A.vals, x, x, x, x, x, x, x.double(), (z, z),
                        A.offsets)
    with pytest.raises(ValueError):        # vector of the wrong length
        fpipe.fused_phase_a(A.vals, x, x, x, x, x[:100], x, (z, z, z),
                            A.offsets)
    with pytest.raises(ValueError):        # band of the wrong width
        fpipe.fused_phase_b(A.vals[:, :100], x, x, x, x, x, x, x, x,
                            (z, z), A.offsets)


# --- double-float (df32) ------------------------------------------------------

def _df_vecs(n, k, dev, seed=1):
    g = np.random.default_rng(seed)
    return [df_from_f64(g.standard_normal(n), dev) for _ in range(k)]


def _df_scalars(dev, *values):
    """0-d DF pairs with a non-zero lo half."""
    return [df_from_f64(np.float64(v) * (1 + 1e-9), dev) for v in values]


def _same(a, b):
    return torch.equal(a.hi, b.hi) and torch.equal(a.lo, b.lo)


def _df_check(got, want, n_vec, pairs, folded=()):
    """Vectors bit-equal, dots within 1e-12 sum|u v|, and the folded
    scalars (the last outputs) equal to the twin's formula on the
    kernel's own dots."""
    for i in range(n_vec):
        assert _same(got[i], want[i]), f"output {i}"
    for j, (u, v) in enumerate(pairs):
        k = n_vec + j
        scale = float(np.abs(df_to_f64(u) * df_to_f64(v)).sum())
        assert abs(float(got[k]) - float(want[k])) <= 1e-12 * scale, j
    assert len(got) == n_vec + len(pairs) + len(folded)
    for j, ref in enumerate(folded):
        assert _same(got[n_vec + len(pairs) + j], ref), f"folded {j}"


def _five_dots(rh, s2, z2, nv):
    """The dots of a CA K2 / phase B output: (r2, r2), (r^, r2),
    (r^, w2), (r^, s2), (r^, z2), with r2, w2 its last two vectors."""
    return lambda out: [(out[nv - 2], out[nv - 2]), (rh, out[nv - 2]),
                        (rh, out[nv - 1]), (rh, s2), (rh, z2)]


def _df_kernel_runs(A, dev):
    """(kernel, plain, args, n_vec, dots' pairs of the outputs, folded
    scalars of the outputs) for the eight DF kernels."""
    n = A.n_rows
    r, p, s, rh, x, q, y, wv, z, vv, t = _df_vecs(n, 11, dev)
    a, b, w, rtr = _df_scalars(dev, 0.7, 0.3, 0.2, 2.5)
    v, o = A.vals, A.offsets
    return [
        (cuda_spmv.dia_spmv_df, cuda_spmv.dia_spmv_df_plain, (v, o, x),
         1, lambda out: [], lambda out: []),
        (fcldf.fused_k1_df, fcldf.fused_k1_df_plain,
         (v, r, p, s, rh, (b, w, rtr), o), 2,
         lambda out: [(rh, out[1])], lambda out: [df_div(rtr, out[2])]),
        (fcldf.fused_k2_df, fcldf.fused_k2_df_plain, (v, r, s, (a,), o), 2,
         lambda out: [(out[0], out[1]), (out[1], out[1])],
         lambda out: [df_div(out[2], out[3])]),
        (fcldf.fused_k3_df, fcldf.fused_k3_df_plain,
         (x, p, q, y, rh, (a, w, rtr)), 2,
         lambda out: [(out[1], out[1]), (rh, out[1])],
         lambda out: [df_mul(df_div(a, w), df_div(out[3], rtr))]),
        (fcadf.fused_ca_k1_df, fcadf.fused_ca_k1_df_plain,
         (v, r, p, s, wv, z, (a, b, w), o), 5,
         lambda out: [(out[3], out[4]), (out[4], out[4])],
         lambda out: [df_div(out[5], out[6])]),
        (fcadf.fused_ca_k2_df, fcadf.fused_ca_k2_df_plain,
         (v, q, y, x, p, rh, s, z, (a, w, rtr), o), 3,
         _five_dots(rh, s, z, 3),
         lambda out: list(fold_beta_alpha(a, w, rtr, *out[4:8]))),
        (fpipedf.fused_phase_a_df, fpipedf.fused_phase_a_df_plain,
         (v, wv, r, p, s, z, vv, (a, b, w), o), 6,
         lambda out: [(out[4], out[5]), (out[5], out[5])],
         lambda out: [df_div(out[6], out[7])]),
        (fpipedf.fused_phase_b_df, fpipedf.fused_phase_b_df_plain,
         (v, z, x, p, q, y, t, rh, s, (a, w, rtr), o), 4,
         _five_dots(rh, s, z, 4),
         lambda out: list(fold_beta_alpha(a, w, rtr, *out[5:9]))),
    ]


@pytest.mark.parametrize("n,offsets", CASES)
def test_df_kernels_match_plain_bit_for_bit(n, offsets):
    dev = _card()
    A = _band(n, offsets, "df32", dev)
    for kern, plain, args, n_vec, pairs, folded in _df_kernel_runs(A, dev):
        before = kern.launches
        got = kern(*args)
        torch.cuda.synchronize()
        assert kern.launches == before + 1, kern.__name__
        got = got if isinstance(got, tuple) else (got,)
        want = plain(*args)
        want = want if isinstance(want, tuple) else (want,)
        _df_check(got, want, n_vec, pairs(got), folded(got))


def test_df_dots_are_deterministic():
    dev = _card()
    A = _band(16384, [1, -1, 40, -40], "df32", dev)
    for kern, _, args, _, _, _ in _df_kernel_runs(A, dev):
        runs = [kern(*args) for _ in range(2)]
        runs = [o if isinstance(o, tuple) else (o,) for o in runs]
        for g, w in zip(*runs):
            assert _same(g, w), kern.__name__


def test_df32_fused_route_launches_each_pass_once_per_iteration():
    dev = _card()
    prob = build_problem(banded_random(8192, [1, -1, 40, -40], seed=12),
                         dtype="df32", device=dev)
    fns = {"fused_k1_df": fcldf.fused_k1_df, "fused_k2_df": fcldf.fused_k2_df,
           "fused_k3_df": fcldf.fused_k3_df,
           "dia_spmv_df": cuda_spmv.dia_spmv_df, "fused_k1": fcl.fused_k1,
           "dia_spmv": cuda_spmv.dia_spmv}
    for fn in fns.values():
        fn.launches = 0
    res = solve(prob.A, prob.b,
                cfg=SolverConfig(tol=0.0, max_iter=25, dtype="df32"))
    assert res.n_iter == 25
    assert {k: fn.launches for k, fn in fns.items()} == {
        "fused_k1_df": 25, "fused_k2_df": 25, "fused_k3_df": 25,
        "dia_spmv_df": 2, "fused_k1": 0, "dia_spmv": 0}


@pytest.mark.parametrize("method,kernels,spmvs", [
    ("ca_bicgstab", (fcadf.fused_ca_k1_df, fcadf.fused_ca_k2_df), 3),
    # the DF pipelined drivers form no t0: r0, w0 and the true residual
    ("pipe_bicgstab", (fpipedf.fused_phase_a_df, fpipedf.fused_phase_b_df),
     3),
    # krr 5, nrr 2: iterations 5 and 10 replace, 5 DF SpMVs each
    ("pipe_bicgstab_rr",
     (fpipedf.fused_phase_a_df, fpipedf.fused_phase_b_df), 3 + 10),
])
def test_df32_ca_and_pipe_routes_launch_their_kernels(method, kernels,
                                                      spmvs):
    dev = _card()
    prob = build_problem(banded_random(8192, [1, -1, 40, -40], seed=12),
                         dtype="df32", device=dev)
    fns = [fcadf.fused_ca_k1_df, fcadf.fused_ca_k2_df,
           fpipedf.fused_phase_a_df, fpipedf.fused_phase_b_df,
           fcldf.fused_k1_df, fca.fused_ca_k1, fpipe.fused_phase_a,
           cuda_spmv.dia_spmv, cuda_spmv.dia_spmv_df]
    for fn in fns:
        fn.launches = 0
    res = solve(prob.A, prob.b, method=method, cfg=SolverConfig(
        tol=0.0, max_iter=25, krr=5, nrr=2, dtype="df32"))
    assert res.n_iter == 25
    per_iter = 23 if method == "pipe_bicgstab_rr" else 25
    want = [per_iter if fn in kernels else 0 for fn in fns]
    want[-1] = spmvs
    assert [fn.launches for fn in fns] == want


@pytest.mark.parametrize("method", ["bicgstab", "bicgstab_l2",
                                    "ca_bicgstab", "pipe_bicgstab",
                                    "pipe_bicgstab_rr"])
def test_df32_solve_on_card_matches_cpu(method):
    dev = _card()
    csr = banded_random(20000, [1, -1, 40, -40, 2000, -2000], seed=3)
    cfg = SolverConfig(tol=1e-11, max_iter=300, krr=4, nrr=2, dtype="df32")
    res = {}
    for d in (dev, "cpu"):
        prob = build_problem(csr, dtype="df32", device=d)
        res[d] = solve(prob.A, prob.b, method=method, cfg=cfg)
    assert bool(res[dev].converged) and bool(res["cpu"].converged)
    assert abs(res[dev].n_iter - res["cpu"].n_iter) <= 2
    assert np.abs(df_to_f64(res[dev].x) - 1.0).max() < 1e-8


@pytest.mark.parametrize("method", ["bicgstab", "bicgstab_l2",
                                    "ca_bicgstab", "pipe_bicgstab",
                                    "pipe_bicgstab_rr"])
def test_tol0_df32_solve_replays_as_a_cuda_graph(method):
    dev = _card()
    prob = build_problem(banded_random(8192, [1, -1, 40, -40], seed=12),
                         dtype="df32", device=dev)
    cfg = SolverConfig(tol=0.0, max_iter=10, krr=4, nrr=2, dtype="df32")
    eager = solve(prob.A, prob.b, method=method, cfg=cfg)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        solve(prob.A, prob.b, method=method, cfg=cfg)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        res = solve(prob.A, prob.b, method=method, cfg=cfg)
    g.replay()
    torch.cuda.synchronize()
    assert res.n_iter == 10 and _same(res.x, eager.x)
    torch.testing.assert_close(res.history, eager.history, rtol=0, atol=0,
                               equal_nan=True)


def test_df_wrappers_raise_instead_of_falling_back():
    dev = _card()
    A = _band(4096, [1, -1, 64, -64], "df32", dev)
    x, = _df_vecs(4096, 1, dev)
    a, = _df_scalars(dev, 0.7)
    with pytest.raises(TypeError):         # float32 vector, not a pair
        cuda_spmv.dia_spmv_df(A.vals, A.offsets, x.hi)
    with pytest.raises(ValueError):        # band on the CPU
        cuda_spmv.dia_spmv_df(A.vals.to("cpu"), A.offsets, x)
    with pytest.raises(TypeError):         # scalar not a pair
        fcldf.fused_k2_df(A.vals, x, x, (a.hi,), A.offsets)
    with pytest.raises(ValueError):        # scalar on the CPU
        fcldf.fused_k2_df(A.vals, x, x, (a.to("cpu"),), A.offsets)
    with pytest.raises(ValueError):        # missing scalar
        fcldf.fused_k3_df(x, x, x, x, x, (a, a))
    with pytest.raises(ValueError):        # vector of the wrong length
        fcldf.fused_k1_df(A.vals, x, x, x[:100], x, (a, a, a), A.offsets)
    with pytest.raises(ValueError):        # missing scalar (rTr)
        fcadf.fused_ca_k2_df(A.vals, x, x, x, x, x, x, x, (a, a),
                             A.offsets)
    with pytest.raises(TypeError):         # float32 vector, not a pair
        fcadf.fused_ca_k1_df(A.vals, x, x, x, x.hi, x, (a, a, a),
                             A.offsets)
    with pytest.raises(ValueError):        # vector on the CPU
        fpipedf.fused_phase_a_df(A.vals, x, x, x, x, x, x.to("cpu"),
                                 (a, a, a), A.offsets)
    with pytest.raises(ValueError):        # band of the wrong width
        fpipedf.fused_phase_b_df(
            DF(A.vals.hi[:, :100].contiguous(),
               A.vals.lo[:, :100].contiguous()), x, x, x, x, x, x, x, x,
            (a, a, a), A.offsets)


def test_df32_host_side_end_to_end(tmp_path):
    """No card needed: the df32 problem build, the DF layouts and their
    SpMVs against the float64 CSR product, an operator and vectors
    carried through convert, and `solve --dtype df32 --device cpu`."""
    csr = banded_random(3000, [1, -1, 40, -40], seed=5)
    prob = build_problem(csr, dtype="df32", device="cpu")
    assert is_df(prob.A.vals) and is_df(prob.b) and is_df(prob.x0)
    assert prob.A.dtype == torch.float32 and fcldf.format_ok(
        prob.A, torch.float32)
    np.testing.assert_allclose(df_to_f64(prob.b),
                               csr.matvec(np.ones(csr.nrows)), rtol=1e-14)
    x64 = np.random.default_rng(2).standard_normal(csr.nrows)
    want = csr.matvec(x64)
    ell = build_operator(csr, format="ell", dtype="df32", device="cpu")
    carried = convert.operator_from_arrays(
        "dia", {"vals_hi": prob.A.vals.hi.numpy(),
                "vals_lo": prob.A.vals.lo.numpy()},
        {"offsets": prob.A.offsets, "n": csr.nrows}, device="cpu")
    split = df_from_f64(x64)
    xdf = convert.df_from_arrays(split.hi.numpy(), split.lo.numpy(),
                                 device="cpu")
    for op in (prob.A, ell, carried):
        y = spmv(op, xdf)
        assert is_df(y)
        np.testing.assert_allclose(df_to_f64(y), want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
    sol = tmp_path / "x.npy"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli.main(["solve", "--matrix", "banded:3000", "--dtype",
                         "df32", "--tol", "1e-11", "--device", "cpu",
                         "--write-solution", str(sol)])
    assert code == 0 and "converged: True" in out.getvalue()
    x = np.load(sol)
    assert x.dtype == np.float64 and np.abs(x - 1.0).max() < 1e-8


# --- the fused df32 shift update (csrc/shift_update_df.cu) --------------------

def _shift_inputs(S, n, dev, frozen_share=0.3, seed=0, offset=0):
    """Random DF state, vectors and folded coefficients (frozen rows:
    0, 0, 0, 0, 1, 0); `offset` > 0 places the state off 16-byte
    alignment."""
    g = np.random.default_rng(seed)

    def state():
        t = [torch.empty(S * n + offset, dtype=torch.float32, device=dev)
             [offset:].view(S, n) for _ in range(2)]
        v = df_from_f64(g.standard_normal((S, n)), dev)
        t[0].copy_(v.hi)
        t[1].copy_(v.lo)
        return DF(t[0], t[1])

    x, p = state(), state()
    q, ro, rn = (df_from_f64(g.standard_normal(n), dev) for _ in range(3))
    active = torch.as_tensor(g.random(S) >= frozen_share, device=dev)
    coefs = []
    for i in range(6):
        c = df_from_f64(g.standard_normal(S), dev)
        fill = 1.0 if i == 4 else 0.0
        coefs.append(DF(torch.where(active, c.hi, fill),
                        torch.where(active, c.lo, 0.0)))
    return [x, p, q, ro, rn, *coefs], active


@pytest.mark.parametrize("S,n,share,offset", [
    (1, 1, 0.3, 0), (5, 37, 0.3, 0), (32, 1024, 0.3, 0),
    (33, 4099, 0.3, 0), (70, 4096, 0.3, 0), (16, 2048, 0.3, 1),
    (16, 2048, 1.0, 0), (16, 2048, 0.0, 0)])
def test_shift_update_kernel_matches_twin_bit_for_bit(S, n, share, offset):
    dev = _card()
    args, active = _shift_inputs(S, n, dev, share, offset=offset)
    x0 = DF(args[0].hi.clone(), args[0].lo.clone())
    p0 = DF(args[1].hi.clone(), args[1].lo.clone())
    want_x, want_p = csu.fused_shift_update_df_plain(*args)
    before = csu.fused_shift_update_df.launches
    got_x, got_p = csu.fused_shift_update_df(*args)
    torch.cuda.synchronize()
    assert csu.fused_shift_update_df.launches == before + 1
    assert got_x is args[0] and got_p is args[1]        # in place
    assert _same(got_x, want_x) and _same(got_p, want_p)
    frozen = ~active
    for got, src in ((got_x, x0), (got_p, p0)):
        assert torch.equal(got.hi[frozen], src.hi[frozen])
        assert torch.equal(got.lo[frozen], src.lo[frozen])


def test_shift_update_wrapper_raises_instead_of_falling_back():
    dev = _card()
    args, _ = _shift_inputs(8, 256, dev)
    bad = list(args)
    bad[2] = args[2].hi                                 # q not a pair
    with pytest.raises(TypeError):
        csu.fused_shift_update_df(*bad)
    bad = list(args)
    bad[5] = args[5].to("cpu")                          # coefficient on CPU
    with pytest.raises(ValueError):
        csu.fused_shift_update_df(*bad)
    bad = list(args)
    bad[3] = args[3][:100]                              # r_old too short
    with pytest.raises(ValueError):
        csu.fused_shift_update_df(*bad)
    bad = list(args)
    bad[6] = args[6][:4]                                # coefficient too short
    with pytest.raises(ValueError):
        csu.fused_shift_update_df(*bad)


def _shifted_problem(dtype, dev, S=8, seed=3, sigma_max=0.01):
    csr = banded_random(8192, [1, -1, 40, -40], seed=12)
    sigma = (np.arange(S) + 1) * (sigma_max / S)
    prob = build_problem(csr, dtype=dtype, device=dev,
                         sigma_seed=float(sigma[seed]))
    return prob, sigma, seed


@pytest.mark.parametrize("dtype,spmv_kernel,update_launches", [
    ("df32", "dia_spmv_df", 10), ("float32", "dia_spmv", 0),
    ("float64", "dia_spmv", 0)])
def test_switching_route_launches_its_kernels(dtype, spmv_kernel,
                                              update_launches):
    """tol=0, 10 iterations: the DF shift update once per iteration (df32
    only), two seed SpMVs per iteration and the true residual's."""
    dev = _card()
    prob, sigma, seed = _shifted_problem(dtype, dev)
    fns = {"shift_update_df": csu.fused_shift_update_df,
           "dia_spmv": cuda_spmv.dia_spmv,
           "dia_spmv_df": cuda_spmv.dia_spmv_df}
    for fn in fns.values():
        fn.launches = 0
    res = solve_shifted(prob.A, prob.b, sigma, seed=seed,
                        method="shifted_lopbicg_switching",
                        cfg=ShiftedConfig(tol=0.0, max_iter=10, dtype=dtype))
    assert res.n_iter == 10
    want = {k: 0 for k in fns}
    want[spmv_kernel] = 2 * 10 + 1
    want["shift_update_df"] = update_launches
    assert {k: fn.launches for k, fn in fns.items()} == want


@pytest.mark.parametrize("dtype,tol,shift_block", [
    ("df32", 1e-10, -1), ("float64", 1e-10, -1), ("float32", 1e-5, 64)])
def test_switching_on_card_matches_cpu(dtype, tol, shift_block):
    """A wide ladder whose top seed stops first, so the solver switches
    seeds. float32 on the card takes the blocked path (auto L = 64); the
    CPU run is given the same L explicitly."""
    dev = _card()
    res = {}
    for d in (dev, "cpu"):
        prob, sigma, seed = _shifted_problem(dtype, d, S=16, seed=15,
                                             sigma_max=4.0)
        res[d] = solve_shifted(prob.A, prob.b, sigma, seed=seed,
                               method="shifted_lopbicg_switching",
                               cfg=ShiftedConfig(tol=tol, max_iter=300,
                                                 dtype=dtype,
                                                 shift_block=shift_block
                                                 if d == "cpu" else -1))
    assert bool(res[dev].stop_flags.all()) and bool(res["cpu"].stop_flags.all())
    assert abs(res[dev].n_iter - res["cpu"].n_iter) <= 2
    assert res[dev].final_seed == res["cpu"].final_seed != 15
    if dtype == "df32":
        x = (df_to_f64(res[dev].x_set), df_to_f64(res["cpu"].x_set))
    else:
        x = (res[dev].x_set.double().cpu().numpy(),
             res["cpu"].x_set.double().numpy())
    np.testing.assert_allclose(*x, atol=1e-3 if dtype == "float32" else 1e-8)


@pytest.mark.parametrize("dtype", ["df32", "float32"])
def test_tol0_switching_replays_as_a_cuda_graph(dtype):
    dev = _card()
    prob, sigma, seed = _shifted_problem(dtype, dev)
    from mpi_bicgstab_tpu_torch.api import _ladder
    sig = _ladder(prob.b, sigma)
    cfg = ShiftedConfig(tol=0.0, max_iter=10, dtype=dtype, shift_block=4
                        if dtype == "float32" else -1)

    def run():
        return solve_shifted(prob.A, prob.b, sig, seed=seed,
                             method="shifted_lopbicg_switching", cfg=cfg)
    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        res = run()
    g.replay()
    torch.cuda.synchronize()
    assert res.n_iter == 10
    if dtype == "df32":
        assert _same(res.x_set, eager.x_set)
    else:
        assert torch.equal(res.x_set, eager.x_set)


@pytest.mark.parametrize("dtype", ["float64", "df32"])
def test_refine_on_card_matches_cpu(dtype):
    """A loose switching solve (tol 1e-4) polished to 1e-10 by the batched
    per-shift BiCGStab over the DIA SpMV kernels (chunks of 4 shifts)."""
    from mpi_bicgstab_tpu_torch.api import refine_shifted_solutions
    dev = _card()
    out = {}
    for d in (dev, "cpu"):
        prob, sigma, seed = _shifted_problem(dtype, d)
        res = solve_shifted(prob.A, prob.b, sigma, seed=seed,
                            method="shifted_lopbicg_switching",
                            cfg=ShiftedConfig(tol=1e-4, dtype=dtype))
        out[d] = refine_shifted_solutions(
            prob.A, prob.b, sigma, res.x_set,
            SolverConfig(tol=1e-10, max_iter=200, dtype=dtype), chunk=4)
    (xg, kg, rg), (xc, kc, rc) = out[dev], out["cpu"]
    assert kg > 0 and abs(kg - kc) <= 2
    assert float(rg.max()) <= 1e-10 and float(rc.max()) <= 1e-10
    f = df_to_f64 if dtype == "df32" else (lambda t: t.double().cpu().numpy())
    np.testing.assert_allclose(f(xg), f(xc), atol=1e-8)


# --- batched right-hand sides (csrc/batched_spmv.cu, fused_batched.cu) -------

def _planes(n, k, m, dev, seed=1):
    """m random [k, n] float32 planes."""
    g = np.random.default_rng(seed)
    return [torch.as_tensor(g.standard_normal((k, n)), dtype=torch.float32,
                            device=dev) for _ in range(m)]


def _lane_scalars(k, dev, frozen=()):
    """Per-lane (alpha, beta, omega, active) [k] tensors; the lanes in
    `frozen` inactive."""
    g = np.random.default_rng(k)
    a, b, w = (torch.as_tensor(g.uniform(0.1, 0.9, k), dtype=torch.float32,
                               device=dev) for _ in range(3))
    act = torch.ones(k, device=dev)
    act[list(frozen)] = 0.0
    return a, b, w, act


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("n,offsets", CASES)
def test_batched_spmv_kernel_matches_plain(n, offsets, k):
    from mpi_bicgstab_tpu_torch.ops import cuda_batched_spmv as cbs
    dev = _card()
    A = _band(n, offsets, torch.float32, dev)
    (X,) = _planes(n, k, 1, dev)
    before = cbs.batched_dia_spmv.launches
    Y = cbs.batched_dia_spmv(A.vals, A.offsets, X)
    torch.cuda.synchronize()
    assert cbs.batched_dia_spmv.launches == before + 1
    _close([Y], [cbs.batched_dia_spmv_plain(A.vals, A.offsets, X)])
    # each lane is the single-lane SpMV of that lane
    for j in range(k):
        _close([Y[j]], [cuda_spmv.dia_spmv(A.vals, A.offsets, X[j])])


@pytest.mark.parametrize("k,frozen", [(1, ()), (3, (1,)), (8, (0, 5))])
@pytest.mark.parametrize("n,offsets", CASES)
def test_fused_batched_kernels_match_plain(n, offsets, k, frozen):
    """K1b, K2b, K3b against their twins; the frozen lanes' outputs are
    their old values bit for bit."""
    from mpi_bicgstab_tpu_torch.ops import cuda_fused_batched as fb
    dev = _card()
    A = _band(n, offsets, torch.float32, dev)
    R, P, S, Rh, X, Q, Y = _planes(n, k, 7, dev)
    a, b, w, act = _lane_scalars(k, dev, frozen)
    v, o = A.vals, A.offsets
    fz = list(frozen)
    for kern, plain, args, keep in (
            (fb.fused_k1b, fb.fused_k1b_plain,
             (v, R, P, S, Rh, (b, w, act), o), (P, S)),
            (fb.fused_k2b, fb.fused_k2b_plain, (v, R, S, (a,), o), None),
            (fb.fused_k3b, fb.fused_k3b_plain,
             (X, P, Q, Y, Rh, (a, w, act)), (X, Q))):
        before = kern.launches
        got = kern(*args)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        want = plain(*args)
        _close(got[:2], want[:2])
        for g_, w_ in zip(got[2:], want[2:]):
            torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-3)
        if keep is not None:
            for out, old in zip(got[:2], keep):
                assert torch.equal(out[fz], old[fz])


def test_batched_limits_match_the_libraries():
    from mpi_bicgstab_tpu_torch.ops import cuda_batched_spmv as cbs
    _card()
    assert cbs._lib().mbt_max_lanes() == cbs.MAX_LANES
    assert cuda_spmv.max_diags() == cbs.MAX_DIAGS


def _batched_problem(dev, k=3, n=8192, seed=12):
    """A DIA problem and k right-hand sides A x_j for seeded x_j (lane 0
    the ones vector), so that the lanes stop at different iterations."""
    csr = banded_random(n, [1, -1, 40, -40], seed=seed)
    prob = build_problem(csr, dtype="float32", device=dev)
    g = np.random.default_rng(seed)
    xs = np.vstack([np.ones(n), g.standard_normal((k - 1, n))])
    B = np.stack([csr.matvec(x) for x in xs])
    return prob, torch.as_tensor(B, dtype=torch.float32, device=dev)


def test_batched_route_launches_each_pass_once_per_iteration():
    from mpi_bicgstab_tpu_torch.api import solve_batched
    from mpi_bicgstab_tpu_torch.ops import cuda_batched_spmv as cbs
    from mpi_bicgstab_tpu_torch.ops import cuda_fused_batched as fb
    dev = _card()
    prob, B = _batched_problem(dev)
    fns = (fb.fused_k1b, fb.fused_k2b, fb.fused_k3b,
           cbs.batched_dia_spmv, fcl.fused_k1, cuda_spmv.dia_spmv)
    for fn in fns:
        fn.launches = 0
    res = solve_batched(prob.A, B,
                        cfg=SolverConfig(tol=0.0, max_iter=25,
                                         dtype="float32"))
    assert res.n_iter.tolist() == [25, 25, 25]
    assert [fn.launches for fn in fns] == [25, 25, 25, 2, 0, 0]


def test_batched_solve_on_card_matches_cpu():
    from mpi_bicgstab_tpu_torch.api import solve_batched
    dev = _card()
    cfg = SolverConfig(tol=1e-6, max_iter=300, dtype="float32")
    res = {}
    for d in (dev, "cpu"):
        prob, B = _batched_problem(d)
        res[d] = solve_batched(prob.A, B, cfg=cfg)
    assert bool(res[dev].converged.all()) and bool(res["cpu"].converged.all())
    assert (res[dev].n_iter - res["cpu"].n_iter).abs().max() <= 2
    assert len(set(res["cpu"].n_iter.tolist())) > 1   # lanes stop apart
    err = float((res[dev].x.cpu() - res["cpu"].x).abs().max())
    assert err < 1e-3, err


def test_tol0_batched_solve_replays_as_a_cuda_graph():
    from mpi_bicgstab_tpu_torch.api import solve_batched
    dev = _card()
    prob, B = _batched_problem(dev)
    cfg = SolverConfig(tol=0.0, max_iter=10, dtype="float32")

    def run():
        return solve_batched(prob.A, B, cfg=cfg)
    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        res = run()
    g.replay()
    torch.cuda.synchronize()
    assert res.n_iter.tolist() == [10, 10, 10]
    assert torch.equal(res.x, eager.x)


def test_batched_wrappers_raise_instead_of_falling_back():
    from mpi_bicgstab_tpu_torch.ops import cuda_batched_spmv as cbs
    from mpi_bicgstab_tpu_torch.ops import cuda_fused_batched as fb
    dev = _card()
    A = _band(4096, [1, -1, 64, -64], torch.float32, dev)
    X, = _planes(4096, 9, 1, dev)
    a, b, w, act = _lane_scalars(3, dev)
    v, o = A.vals, A.offsets
    with pytest.raises(ValueError):        # 9 lanes
        cbs.batched_dia_spmv(v, o, X)
    with pytest.raises(ValueError):        # one lane as a vector
        cbs.batched_dia_spmv(v, o, X[0])
    with pytest.raises(TypeError):         # float64 planes
        cbs.batched_dia_spmv(v, o, X[:3].double())
    with pytest.raises(ValueError):        # not contiguous
        cbs.batched_dia_spmv(v, o, X[:3, ::2])
    R = X[:3].contiguous()
    with pytest.raises(ValueError):        # scalar of the wrong length
        fb.fused_k2b(v, R, R, (a[:2],), o)
    with pytest.raises(ValueError):        # scalar on the CPU
        fb.fused_k1b(v, R, R, R, R, (b, w, act.cpu()), o)
    with pytest.raises(ValueError):        # missing scalar
        fb.fused_k3b(R, R, R, R, R, (a, w))
    with pytest.raises(ValueError):        # band on the CPU
        fb.fused_k2b(v.cpu(), R, R, (a,), o)
    with pytest.raises(ValueError):        # planes of different shapes
        fb.fused_k3b(R, R, R[:2], R, R, (a, w, act))


# --- Chebyshev chains and the DF pipelined bodies (slices 7 and 3c) ---------

@pytest.mark.parametrize("degree", [1, 2, 8])
@pytest.mark.parametrize("n,offsets", CASES)
def test_cheby_chain_kernels_match_plain(n, offsets, degree):
    """The float32 chain within 2e-6 of the twin's largest entry (the JAX
    package's bar for its chain kernel), the DF chain bit for bit."""
    from mpi_bicgstab_tpu_torch.ops import cuda_cheby as cc
    dev = _card()
    lo, hi = 0.05, 9.0
    A32 = _band(n, offsets, torch.float32, dev)
    Adf = _band(n, offsets, "df32", dev)
    (v,) = _vecs(n, 1, dev)
    (vdf,) = _df_vecs(n, 1, dev)
    before = (cc.cheby_chain.launches, cc.cheby_chain_df.launches)
    got = cc.cheby_chain(A32.vals, v, A32.offsets, degree, lo, hi)
    got_df = cc.cheby_chain_df(Adf.vals, vdf, Adf.offsets, degree, lo, hi)
    torch.cuda.synchronize()
    assert (cc.cheby_chain.launches, cc.cheby_chain_df.launches) == (
        before[0] + 1, before[1] + 1)
    want = cc.cheby_chain_plain(A32.vals, v, A32.offsets, degree, lo, hi)
    assert float((got - want).abs().max()) <= 2e-6 * float(want.abs().max())
    assert _same(got_df, cc.cheby_chain_df_plain(Adf.vals, vdf, Adf.offsets,
                                                 degree, lo, hi))


@pytest.mark.parametrize("n", [100, 5000, 16384])
def test_pipe_df_body_kernels_match_plain_bit_for_bit(n):
    from mpi_bicgstab_tpu_torch.ops import cuda_pipe_df_bodies as cpb
    dev = _card()
    r, p, s, rh, x, q, y, wv, z, vv, t = _df_vecs(n, 11, dev)
    a, b, w = _df_scalars(dev, 0.7, 0.3, 0.2)
    for kern, plain, args, n_vec, pairs in (
            (cpb.fused_body_a, cpb.fused_body_a_plain,
             (r, p, s, wv, z, t, vv, (a, b, w)), 5,
             lambda out: [(out[3], out[4]), (out[4], out[4])]),
            (cpb.fused_body_b, cpb.fused_body_b_plain,
             (x, p, q, y, t, vv, rh, s, z, (a, w)), 3,
             lambda out: [(out[1], out[1]), (rh, out[1]), (rh, out[2]),
                          (rh, s), (rh, z)])):
        before = kern.launches
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        flat = lambda o: (*o[:-1], *o[-1])  # noqa: E731
        _df_check(flat(got), flat(want), n_vec, pairs(got))


@pytest.mark.parametrize("dtype,method,chain,spmv,per_segment", [
    ("float32", "bicgstab", "cheby_chain", "dia_spmv", 2),
    ("df32", "bicgstab", "cheby_chain_df", "dia_spmv_df", 2),
    ("df32", "pipe_bicgstab", "cheby_chain_df", "dia_spmv_df", 4),
])
def test_cheby_routes_launch_their_kernels(dtype, method, chain, spmv,
                                           per_segment):
    """A preconditioned tol=0 solve of 10 iterations: p(A) through the
    chain kernel twice per iteration, per_segment times at set-up and
    exit, once for x = p(A) y; df32 pipe_bicgstab's body kernels once
    each per iteration; no fused pass."""
    from mpi_bicgstab_tpu_torch.ops import cuda_cheby as cc
    from mpi_bicgstab_tpu_torch.ops import cuda_pipe_df_bodies as cpb
    from mpi_bicgstab_tpu_torch.ops.cheby import ChebyPrecond
    dev = _card()
    prob = build_problem(banded_random(8192, [1, -1, 40, -40], seed=12),
                         dtype=dtype, device=dev)
    fns = {"cheby_chain": cc.cheby_chain, "cheby_chain_df": cc.cheby_chain_df,
           "dia_spmv": cuda_spmv.dia_spmv,
           "dia_spmv_df": cuda_spmv.dia_spmv_df,
           "fused_body_a": cpb.fused_body_a, "fused_body_b": cpb.fused_body_b,
           "fused_k1": fcl.fused_k1, "fused_k1_df": fcldf.fused_k1_df,
           "fused_phase_a_df": fpipedf.fused_phase_a_df}
    for fn in fns.values():
        fn.launches = 0
    res = solve(prob.A, prob.b, method=method,
                cfg=SolverConfig(tol=0.0, max_iter=10, dtype=dtype),
                precond=ChebyPrecond(4, 0.05, 9.0))
    assert res.n_iter == 10
    want = dict.fromkeys(fns, 0)
    want[spmv] = 2 * 10 + per_segment
    want[chain] = want[spmv] + 1
    if method == "pipe_bicgstab":
        want["fused_body_a"] = want["fused_body_b"] = 10
    assert {k: fn.launches for k, fn in fns.items()} == want


@pytest.mark.parametrize("dtype,method", [("float32", "bicgstab"),
                                          ("df32", "bicgstab"),
                                          ("df32", "pipe_bicgstab"),
                                          ("float64", "bicgstab")])
def test_cheby_solve_on_card_matches_cpu(dtype, method):
    from mpi_bicgstab_tpu_torch.models.generators import transport_hard
    from mpi_bicgstab_tpu_torch.ops.cheby import ChebyPrecond, estimate_bounds
    dev = _card()
    csr = transport_hard(4096)
    prec = ChebyPrecond(8, *estimate_bounds(csr))
    tol = 1e-5 if dtype == "float32" else 1e-10
    cfg = SolverConfig(tol=tol, max_iter=500, dtype=dtype)
    res = {}
    for d in (dev, "cpu"):
        prob = build_problem(csr, dtype=dtype, device=d)
        res[d] = solve(prob.A, prob.b, method=method, cfg=cfg, precond=prec)
    assert bool(res[dev].converged) and bool(res["cpu"].converged)
    assert abs(res[dev].n_iter - res["cpu"].n_iter) <= 2
    x = df_to_f64(res[dev].x) if is_df(res[dev].x) else \
        res[dev].x.double().cpu().numpy()
    assert np.abs(x - 1.0).max() < (3e-2 if dtype == "float32" else 1e-6)


@pytest.mark.parametrize("dtype,method", [("float32", "bicgstab"),
                                          ("df32", "pipe_bicgstab")])
def test_tol0_cheby_solve_replays_as_a_cuda_graph(dtype, method):
    """The chain kernels take their coefficients by value, so a
    preconditioned tol=0 solve (exit transform included) captures."""
    from mpi_bicgstab_tpu_torch.ops.cheby import ChebyPrecond
    dev = _card()
    prob = build_problem(banded_random(8192, [1, -1, 40, -40], seed=12),
                         dtype=dtype, device=dev)
    cfg = SolverConfig(tol=0.0, max_iter=6, dtype=dtype)
    prec = ChebyPrecond(4, 0.05, 9.0)
    eager = solve(prob.A, prob.b, method=method, cfg=cfg, precond=prec)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        solve(prob.A, prob.b, method=method, cfg=cfg, precond=prec)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        res = solve(prob.A, prob.b, method=method, cfg=cfg, precond=prec)
    g.replay()
    torch.cuda.synchronize()
    same = _same(res.x, eager.x) if is_df(res.x) else torch.equal(res.x,
                                                                   eager.x)
    assert res.n_iter == 6 and same


def test_cheby_and_body_wrappers_raise_instead_of_falling_back():
    from mpi_bicgstab_tpu_torch.ops import cuda_cheby as cc
    from mpi_bicgstab_tpu_torch.ops import cuda_pipe_df_bodies as cpb
    dev = _card()
    A32 = _band(4096, [1, -1, 64, -64], torch.float32, dev)
    Adf = _band(4096, [1, -1, 64, -64], "df32", dev)
    (v,) = _vecs(4096, 1, dev)
    (x,) = _df_vecs(4096, 1, dev)
    a, = _df_scalars(dev, 0.7)
    with pytest.raises(TypeError):         # float64 vector
        cc.cheby_chain(A32.vals, v.double(), A32.offsets, 4, 0.1, 9.0)
    with pytest.raises(ValueError):        # degree beyond the kernel's
        cc.cheby_chain(A32.vals, v, A32.offsets, cc.MAX_DEGREE + 1, 0.1, 9.0)
    with pytest.raises(ValueError):        # band on the CPU
        cc.cheby_chain(A32.vals.cpu(), v, A32.offsets, 4, 0.1, 9.0)
    with pytest.raises(TypeError):         # float32 vector, not a pair
        cc.cheby_chain_df(Adf.vals, x.hi, Adf.offsets, 4, 0.1, 9.0)
    with pytest.raises(ValueError):        # vector of the wrong length
        cc.cheby_chain_df(Adf.vals, x[:100], Adf.offsets, 4, 0.1, 9.0)
    with pytest.raises(TypeError):         # float32 vector, not a pair
        cpb.fused_body_a(x, x, x, x.hi, x, x, x, (a, a, a))
    with pytest.raises(ValueError):        # missing scalar
        cpb.fused_body_b(x, x, x, x, x, x, x, x, x, (a,))
    with pytest.raises(ValueError):        # vector on the CPU
        cpb.fused_body_b(x, x, x, x, x, x, x.to("cpu"), x, x, (a, a))


# --- windowed-ELL SpMV (kernels 23, 24) --------------------------------------

def _window(dtype, dev, case):
    """A windowed-ELL layout on the card: 'tail' a clustered matrix with a
    leveled tail, 'beyond' tile 0's window forced past the last column (its
    padded slots point beyond n_cols and must read 0), 'wide' 8 nonzeros per
    row (W = 24)."""
    from mpi_bicgstab_tpu_torch.models.generators import clustered_random
    from mpi_bicgstab_tpu_torch.ops.window_ell import csr_to_window_ell
    kw = {}
    if case == "wide":
        csr = clustered_random(8192, seed=2)
    else:
        csr = clustered_random(2048, nnz_per_row=3, seed=9,
                               global_frac=0.02)
        if case == "beyond":
            kw = dict(window_base=np.array([2, 1]), force_x_rows=24)
    return csr, csr_to_window_ell(csr, dtype=dtype, device=dev, **kw)


@pytest.mark.parametrize("case", ["tail", "beyond", "wide"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, "df32"])
def test_window_kernels_match_twins_bit_for_bit(dtype, case):
    """Kernels 23 (float32, float64) and 24 (DF) against their twins on
    the same inputs: equal bit for bit (no contraction, slab order); the
    whole SpMV (kernel plus tail) against the CSR."""
    from mpi_bicgstab_tpu_torch.ops import cuda_window_spmv as cws
    from mpi_bicgstab_tpu_torch.ops import window_spmv as wsp
    dev = _card()
    csr, A = _window(dtype, dev, case)
    x_host = np.random.default_rng(3).standard_normal(csr.nrows)
    if dtype == "df32":
        x = df_from_f64(x_host, dev)
        before = cws.window_slabs_df.launches
        got = cws.window_slabs_df(A, x)
        torch.cuda.synchronize()
        assert cws.window_slabs_df.launches == before + 1
        assert _same(got, wsp.window_slabs_df_plain(A, x))
        y = df_to_f64(spmv(A, x))
    else:
        x = torch.as_tensor(x_host, dtype=dtype, device=dev)
        before = cws.window_slabs.launches
        got = cws.window_slabs(A, x)
        torch.cuda.synchronize()
        assert cws.window_slabs.launches == before + 1
        assert torch.equal(got, wsp.window_slabs_plain(A, x))
        y = spmv(A, x).double().cpu().numpy()
    ref = csr.matvec(x_host)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert np.abs(y - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("dtype,method", [("float32", "bicgstab"),
                                          ("float64", "bicgstab"),
                                          ("df32", "bicgstab"),
                                          ("df32", "pipe_bicgstab")])
def test_window_route_launches_its_kernel(dtype, method):
    """A solve on the window layout runs the window SpMV kernel (the DF one
    for df32; df32 pipe_bicgstab also its fused bodies once per
    iteration) and no DIA kernel, and agrees with the CPU solve."""
    from mpi_bicgstab_tpu_torch.models.generators import clustered_random
    from mpi_bicgstab_tpu_torch.ops import cuda_pipe_df_bodies as cpb
    from mpi_bicgstab_tpu_torch.ops import cuda_window_spmv as cws
    dev = _card()
    csr = clustered_random(8192, seed=4)
    tol = 1e-6 if dtype == "float32" else 1e-10
    dt = dtype if dtype == "df32" else getattr(torch, dtype)
    cfg = SolverConfig(tol=tol, dtype=dtype)
    counters = {"window": cws.window_slabs, "window_df": cws.window_slabs_df,
                "dia": cuda_spmv.dia_spmv, "dia_df": cuda_spmv.dia_spmv_df,
                "body_a": cpb.fused_body_a}
    cpu = build_problem(csr, dtype=dt, device="cpu")
    ref = solve(cpu.A, cpu.b, method=method, cfg=cfg)
    prob = build_problem(csr, dtype=dt, device=dev)
    assert type(prob.A).__name__ == "WindowEllMatrix"
    before = {k: f.launches for k, f in counters.items()}
    res = solve(prob.A, prob.b, method=method, cfg=cfg)
    assert bool(res.converged) and abs(res.n_iter - ref.n_iter) <= 2
    used = {k: f.launches - before[k] for k, f in counters.items()}
    spmv_name = "window_df" if dtype == "df32" else "window"
    assert used.pop(spmv_name) >= 2 * res.n_iter
    bodies = res.n_iter if method == "pipe_bicgstab" else 0
    assert used == {**dict.fromkeys(used, 0), "body_a": bodies}


def test_window_wrappers_raise_instead_of_falling_back():
    from mpi_bicgstab_tpu_torch.ops import cuda_window_spmv as cws
    dev = _card()
    _, A = _window(torch.float32, dev, "tail")
    _, Adf = _window("df32", dev, "tail")
    x = torch.ones(A.n_cols, device=dev)
    with pytest.raises(TypeError):         # float64 x, float32 values
        cws.window_slabs(A, x.double())
    with pytest.raises(ValueError):        # x on the CPU
        cws.window_slabs(A, x.cpu())
    with pytest.raises(ValueError):        # x of the wrong length
        cws.window_slabs(A, x[:100])
    with pytest.raises(TypeError):         # float32 x, not a pair
        cws.window_slabs_df(Adf, x)
    with pytest.raises(TypeError):         # DF x, float32 values
        cws.window_slabs_df(A, DF(x, x))


# --- butterfly SpMV (kernels 25-28) ------------------------------------------

def _butterfly(dtype, dev, case):
    """A butterfly layout on the card: 'routed' uniform random (rb = 64),
    'rb32' 12 nonzeros a row (rb = 32, four stacked windows), 'beyond'
    3000 columns with random K1/K2 tables whose first windows read the
    last source window (slots past column 2999 must read 0)."""
    from mpi_bicgstab_tpu_torch.models.generators import random_diag_dominant
    from mpi_bicgstab_tpu_torch.ops.butterfly import build_butterfly
    if case == "rb32":
        csr = random_diag_dominant(20480, nnz_per_row=12, seed=1)
    else:
        csr = random_diag_dominant(3000 if case == "beyond" else 4096,
                                   seed=3)
    A = build_butterfly(csr, dtype=dtype, device=dev)
    if case == "beyond":
        import dataclasses
        g = np.random.default_rng(5)

        def rand(hi):
            return torch.as_tensor(g.integers(0, hi, (A.P, 8, 128)).astype(
                np.int8), device=dev)
        src = g.integers(0, A.nc_pad // 1024, A.P).astype(np.int32)
        src[:4] = A.nc_pad // 1024 - 1
        A = dataclasses.replace(A, k1_src=torch.as_tensor(src, device=dev),
                                k1_sub=rand(8), k1_lane=rand(128),
                                k2_sub=rand(8), k2_lane=rand(128))
    return csr, A


@pytest.mark.parametrize("case", ["routed", "rb32", "beyond"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, "df32"])
def test_butterfly_kernels_match_twins_bit_for_bit(dtype, case):
    """Kernels 25-26 (K1, K2: a DF vector as packed pairs) and 27-28 (K3,
    K3 DF) against their twins on the same inputs: equal bit for bit;
    each launch counted once; the whole SpMV against the CSR (routed
    tables only)."""
    from mpi_bicgstab_tpu_torch.ops import butterfly_spmv as bs
    from mpi_bicgstab_tpu_torch.ops import cuda_butterfly as cbf
    dev = _card()
    csr, A = _butterfly(dtype, dev, case)
    x_host = np.random.default_rng(3).standard_normal(csr.shape[1])
    df = dtype == "df32"
    x = df_from_f64(x_host, dev) if df else torch.as_tensor(
        x_host, dtype=dtype, device=dev)
    v = bs.pack_df(x) if df else x
    before = {f: f.launches for f in (cbf.butterfly_k1, cbf.butterfly_k2,
                                      cbf.butterfly_k3, cbf.butterfly_k3_df)}
    u1 = cbf.butterfly_k1(A, v)
    assert torch.equal(u1, bs.k1_plain(A, v))
    mid = bs.transpose(A, u1)
    z1 = cbf.butterfly_k2(A, mid)
    assert torch.equal(z1, bs.k2_plain(A, mid))
    z = bs.transpose(A, z1)
    if df:
        assert _same(cbf.butterfly_k3_df(A, z), bs.k3_df_plain(A, z))
    else:
        assert torch.equal(cbf.butterfly_k3(A, z), bs.k3_plain(A, z))
    torch.cuda.synchronize()
    k3 = cbf.butterfly_k3_df if df else cbf.butterfly_k3
    assert {f: f.launches - n for f, n in before.items()} == {
        **dict.fromkeys(before, 0), cbf.butterfly_k1: 1,
        cbf.butterfly_k2: 1, k3: 1}
    if case == "beyond":
        return
    y = df_to_f64(spmv(A, x)) if df else spmv(A, x).double().cpu().numpy()
    ref = csr.matvec(x_host)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert np.abs(y - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("dtype,method", [("float32", "bicgstab"),
                                          ("float64", "bicgstab"),
                                          ("df32", "bicgstab"),
                                          ("df32", "pipe_bicgstab")])
def test_butterfly_route_launches_its_kernels(dtype, method):
    """A solve on the butterfly layout runs K1, K2 and K3 (K3 DF in df32)
    once per SpMV, df32 pipe_bicgstab also its fused bodies once per
    iteration, and no other kernel; it agrees with the CPU solve."""
    from mpi_bicgstab_tpu_torch.models.generators import random_diag_dominant
    from mpi_bicgstab_tpu_torch.ops import cuda_butterfly as cbf
    from mpi_bicgstab_tpu_torch.ops import cuda_pipe_df_bodies as cpb
    from mpi_bicgstab_tpu_torch.ops import cuda_window_spmv as cws
    dev = _card()
    csr = random_diag_dominant(8192, seed=4)
    tol = 1e-6 if dtype == "float32" else 1e-10
    dt = dtype if dtype == "df32" else getattr(torch, dtype)
    cfg = SolverConfig(tol=tol, dtype=dtype)
    counters = {"k1": cbf.butterfly_k1, "k2": cbf.butterfly_k2,
                "k3": cbf.butterfly_k3, "k3_df": cbf.butterfly_k3_df,
                "window": cws.window_slabs, "dia": cuda_spmv.dia_spmv,
                "dia_df": cuda_spmv.dia_spmv_df, "body_a": cpb.fused_body_a}
    cpu = build_problem(csr, dtype=dt, device="cpu")
    ref = solve(cpu.A, cpu.b, method=method, cfg=cfg)
    prob = build_problem(csr, dtype=dt, device=dev)
    assert type(prob.A).__name__ == "ButterflyMatrix"
    before = {k: f.launches for k, f in counters.items()}
    res = solve(prob.A, prob.b, method=method, cfg=cfg)
    assert bool(res.converged) and abs(res.n_iter - ref.n_iter) <= 2
    used = {k: f.launches - before[k] for k, f in counters.items()}
    k3 = "k3_df" if dtype == "df32" else "k3"
    spmvs = used.pop(k3)
    assert spmvs >= 2 * res.n_iter
    assert used.pop("k1") == used.pop("k2") == spmvs
    bodies = res.n_iter if method == "pipe_bicgstab" else 0
    assert used == {**dict.fromkeys(used, 0), "body_a": bodies}


def test_butterfly_wrappers_raise_instead_of_falling_back():
    from mpi_bicgstab_tpu_torch.ops import cuda_butterfly as cbf
    dev = _card()
    _, A = _butterfly(torch.float32, dev, "routed")
    _, Adf = _butterfly("df32", dev, "routed")
    x = torch.ones(A.n_cols, device=dev)
    z = torch.ones(A.P * 1024, device=dev)
    with pytest.raises(TypeError):         # a float16 vector
        cbf.butterfly_k1(A, x.half())
    with pytest.raises(ValueError):        # x on the CPU
        cbf.butterfly_k1(A, x.cpu())
    with pytest.raises(ValueError):        # x of the wrong length
        cbf.butterfly_k1(A, x[:100])
    with pytest.raises(ValueError):        # mid of the wrong length
        cbf.butterfly_k2(A, x)
    with pytest.raises(TypeError):         # float64 z, float32 values
        cbf.butterfly_k3(A, z.double())
    with pytest.raises(TypeError):         # DF values take the DF kernel
        cbf.butterfly_k3(Adf, z)
    with pytest.raises(TypeError):         # float32 z, not packed pairs
        cbf.butterfly_k3_df(Adf, z)
    with pytest.raises(TypeError):         # float values, not a DF pair
        cbf.butterfly_k3_df(A, z.double().view(torch.int64))
