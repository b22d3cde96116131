"""The fused DF iteration bodies of classic BiCGStab
(ops/cuda_classic_df_bodies.py, passes P, A, Q, O, with kernel 11 as
pass X) and the route that runs them: solvers/bicgstab.bicgstab on DF
pairs, around any operator.

The twins (what the wrappers run for CPU tensors) are the unfused DF
loop's steps (solvers/bicgstab._classic, the route before the bodies)
with the same operations in the same order, so each pass and a whole
solve equal that loop bit for bit on the CPU: on a Chebyshev operator,
on ELL, with out_iter and under serialize_comm, and on two gloo ranks,
where the passes' dots are the rank's own and the scalars come from the
reduced dots. The bodies take every DF right-hand side and no float32 or
float64 one. No JAX here: the ranks load this file (launch.call_script).
"""
import contextlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch

import mpi_bicgstab_tpu_torch.api as tapi
import mpi_bicgstab_tpu_torch.ops.cuda_classic_df_bodies as ccb
import mpi_bicgstab_tpu_torch.ops.cuda_fused_classic_df as fcldf
import mpi_bicgstab_tpu_torch.solvers.bicgstab as tb
from mpi_bicgstab_tpu_torch.models import generators as tgen
from mpi_bicgstab_tpu_torch.models import problem as tprob
from mpi_bicgstab_tpu_torch.ops import cheby, layout
from mpi_bicgstab_tpu_torch.ops.blas import axpy
from mpi_bicgstab_tpu_torch.ops.precision import df_from_f64, is_df
from mpi_bicgstab_tpu_torch.parallel import driver, launch
from mpi_bicgstab_tpu_torch.parallel.comm import Comm
from mpi_bicgstab_tpu_torch.parallel.partition import partition_csr
from mpi_bicgstab_tpu_torch.utils.config import SolverConfig

torch.set_num_threads(1)
SCRIPT = str(Path(__file__).resolve())
PASSES = ("classic_df_p", "classic_df_a", "classic_df_q", "classic_df_o")


def _inputs(n, seed):
    """DF vectors and scalars from a seeded NumPy generator."""
    rng = np.random.default_rng(seed)
    v = {k: df_from_f64(rng.standard_normal(n))
         for k in ("r", "p", "s", "rh", "x", "q", "y")}
    v.update({k: df_from_f64(np.float64(c) * (1 + 1e-9)) for k, c in
              (("al", 0.7), ("be", 0.3), ("om", 0.25), ("rtr", 2.5))})
    return v


def _new_and_old(name, v):
    """A pass's outputs and the unfused loop's for the same quantities
    (solvers/bicgstab._classic), each a list of DF pairs."""
    comm = Comm()
    if name == "classic_df_p":                          # solver.c:117-119
        return ([ccb.classic_df_p(v["r"], v["p"], v["s"],
                                  (v["be"], v["om"]))],
                [axpy(v["be"], axpy(-v["om"], v["s"], v["p"]), v["r"])])
    if name == "classic_df_a":                          # solver.c:89-93
        dots, alpha = ccb.classic_df_a(v["rh"], v["s"], (v["rtr"],))
        rTs = comm.dot(v["rh"], v["s"])
        return [*dots, alpha], [rTs, v["rtr"] / rTs]
    if name == "classic_df_q":                          # solver.c:94
        return ([ccb.classic_df_q(v["r"], v["s"], (v["al"],))],
                [axpy(-v["al"], v["s"], v["r"])])
    if name == "classic_df_o":                          # solver.c:97-104
        dots, omega = ccb.classic_df_o(v["q"], v["y"])
        qTy, yTy = comm.dots((v["q"], v["y"]), (v["y"], v["y"]))
        return [*dots, omega], [qTy, yTy, qTy / yTy]
    # pass X, kernel 11                                 # solver.c:105-116
    al, om, rtr = v["al"], v["om"], v["rtr"]
    new = fcldf.fused_k3_df(v["x"], v["p"], v["q"], v["y"], v["rh"],
                            (al, om, rtr))
    x2 = axpy(om, v["q"], axpy(al, v["p"], v["x"]))
    r2 = axpy(-om, v["y"], v["q"])
    dot_r, rtr2 = comm.dots((r2, r2), (v["rh"], r2))
    return list(new), [x2, r2, dot_r, rtr2, (al / om) * (rtr2 / rtr)]


def _same(a, b) -> bool:
    return torch.equal(a.hi, b.hi) and torch.equal(a.lo, b.lo)


@pytest.mark.parametrize("n,seed", [(4096, 11), (1000, 13)])
@pytest.mark.parametrize("name", [*PASSES, "fused_k3_df"])
def test_pass_twin_is_the_unfused_step(name, n, seed):
    new, old = _new_and_old(name, _inputs(n, seed))
    assert len(new) == len(old)
    for i, (a, b) in enumerate(zip(new, old)):
        assert a.shape == b.shape and _same(a, b), (name, i)


def test_wrappers_count_nothing_on_the_cpu():
    before = [getattr(ccb, k).launches for k in PASSES]
    for name in PASSES:
        _new_and_old(name, _inputs(1000, 13))
    assert [getattr(ccb, k).launches for k in PASSES] == before


# --- solves ----------------------------------------------------------------

def _operator(case):
    """(operator, b, x0, cfg) of a df32 solve off the fully fused route."""
    if case == "cheby":
        csr = tgen.transport_hard(2048)
        p = tprob.build_problem(csr, dtype="df32", multiple=1, device="cpu")
        A = cheby.wrap_operator(p.A, cheby.ChebyPrecond(8).resolve(csr))
        cfg = SolverConfig(tol=1e-12, max_iter=500, dtype="df32")
        return A, p.b, p.x0, cfg
    csr = tgen.banded_random(2000, [1, -1, 30, -30], seed=4)
    fmt = "ell" if case == "ell" else "dia"
    p = tprob.build_problem(csr, dtype="df32", multiple=1, device="cpu",
                            format=fmt)
    cfg = SolverConfig(tol=1e-11, max_iter=300, dtype="df32")
    if case == "out_iter":
        cfg = cfg.replace(out_iter=5)
    elif case == "serialize":
        cfg = cfg.replace(serialize_comm=True)
    return p.A, p.b, p.x0, cfg


@pytest.mark.parametrize("case", ["cheby", "ell", "out_iter", "serialize"])
def test_df32_solve_equals_the_unfused_loop(case):
    """The bodies' solve and the unfused DF loop's: the same n_iter,
    iterate, history and residuals, bit for bit (and the same prints)."""
    A, b, x0, cfg = _operator(case)
    out = {}
    for name, loop in (("bodies", tb.bicgstab), ("unfused", tb._classic)):
        with contextlib.redirect_stdout(io.StringIO()) as text:
            res = loop(lambda v: layout.spmv(A, v),
                       Comm(serialize=cfg.serialize_comm), b, x0, cfg)
        out[name] = (res, text.getvalue())
    (new, new_text), (old, old_text) = out["bodies"], out["unfused"]
    assert bool(new.converged) and new.n_iter == old.n_iter > 0
    assert _same(new.x, old.x)
    assert torch.equal(new.history.nan_to_num(-1.0),
                       old.history.nan_to_num(-1.0))
    assert torch.equal(new.true_relres, old.true_relres)
    assert new_text == old_text
    assert (new_text.count("iter ") == new.n_iter // 5 if case == "out_iter"
            else new_text == "")


def _spy(monkeypatch):
    calls = dict.fromkeys((*PASSES, "fused_k3_df"), 0)
    for name in calls:
        mod = fcldf if name == "fused_k3_df" else ccb

        def spy(*args, _fn=getattr(mod, name), _key=name):
            calls[_key] += 1
            return _fn(*args)
        monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.mark.parametrize("dtype,fmt", [("df32", "ell"), ("df32", "dia"),
                                       ("float32", "ell"),
                                       ("float64", "ell")])
def test_route_follows_the_right_hand_side(dtype, fmt, monkeypatch):
    """api.solve: a DF b off the fully fused route (ELL) runs every pass
    once an iteration; a DF b on a DiaMatrix keeps kernels 9-11 (pass X
    is kernel 11, no body runs); float32 and float64 b run none."""
    csr = tgen.banded_random(2000, [1, -1, 30, -30], seed=4)
    p = tprob.build_problem(csr, dtype=dtype, multiple=1, device="cpu",
                            format=fmt)
    calls = _spy(monkeypatch)
    tol = 1e-5 if dtype == "float32" else 1e-11
    res = tapi.solve(p.A, p.b, method="bicgstab",
                     cfg=SolverConfig(tol=tol, max_iter=300, dtype=dtype,
                                      restarts=0))
    assert bool(res.converged) and res.n_iter > 0
    if dtype == "df32" and fmt == "ell":
        want = dict.fromkeys(calls, res.n_iter)
    else:
        want = dict.fromkeys(calls, 0)
        if dtype == "df32":
            want["fused_k3_df"] = res.n_iter
    assert calls == want


# --- two gloo ranks ----------------------------------------------------------

@pytest.fixture(scope="module")
def pool():
    with launch.Pool(2, device="cpu") as p:
        yield p


def solve_with_loop(part, b, cfg, loop: str, precond=None):
    """solve_distributed with classic BiCGStab run by `loop` ("bodies":
    solvers/bicgstab.bicgstab; "unfused": _classic): a task for the
    ranks, which load this file through launch.call_script."""
    saved = tb.CLASSIC_SOLVERS["bicgstab"]
    if loop == "unfused":
        tb.CLASSIC_SOLVERS["bicgstab"] = tb._classic
    try:
        return driver.solve_distributed(part, b, method="bicgstab", cfg=cfg,
                                        precond=precond)
    finally:
        tb.CLASSIC_SOLVERS["bicgstab"] = saved


@pytest.mark.parametrize("case", ["ell", "cheby"])
def test_two_ranks(pool, case):
    """df32 classic on two ranks off the halo-fused route takes the
    bodies with the reductions in the solver: bit-equal to the unfused
    DF loop on the same ranks, and within the distributed tests' bars of
    the one-device solve (n_iter within 2, the same answer)."""
    if case == "cheby":
        csr = tgen.transport_hard(2048)
        prec = cheby.ChebyPrecond(8).resolve(csr)
        part = partition_csr(csr, 2, dtype="df32")
        cfg = SolverConfig(tol=1e-12, max_iter=500, dtype="float32")
    else:
        csr, prec = tgen.banded_random(2000, [1, -1, 30, -30], seed=4), None
        part = partition_csr(csr, 2, dtype="df32", format="ell")
        cfg = SolverConfig(tol=1e-11, max_iter=300, dtype="float32")
    b = csr.matvec(np.ones(csr.nrows))
    out = {loop: pool.run(launch.call_script, SCRIPT, "solve_with_loop",
                          part, b, cfg, loop, precond=prec)
           for loop in ("bodies", "unfused")}
    new, old = out["bodies"], out["unfused"]
    assert is_df(new.x) and new.n_iter == old.n_iter > 0
    assert np.array_equal(new.x.hi, old.x.hi)
    assert np.array_equal(new.x.lo, old.x.lo)
    assert np.array_equal(np.asarray(new.history), np.asarray(old.history),
                          equal_nan=True)
    p = tprob.build_problem(csr, dtype="df32", multiple=1, device="cpu")
    one = tapi.solve(p.A, p.b, method="bicgstab", precond=prec,
                     cfg=cfg.replace(dtype="df32"))
    assert bool(new.converged) and bool(one.converged)
    assert abs(new.n_iter - one.n_iter) <= 2
    x = launch.result_array(new.x)[:csr.nrows]
    np.testing.assert_allclose(x, 1.0, rtol=0, atol=1e-8)
