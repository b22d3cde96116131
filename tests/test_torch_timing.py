"""The port's tracing (utils/timing.py) on the four routes the benchmark
runs: the fused df32 driver, the unfused float64 BiCGStab, the unfused
df32 BiCGStab over a Chebyshev operator and the df32 seed-switching
solve.

With no profiler no span records anything; under a CPU torch.profiler
each route gives one `mbt.iter` span an iteration, one `mbt.sync` an
iteration plus the reads before the loop and at its exit, spans nested
from `mbt.solve` down to the kernel wrappers' `mbt.launch.*`, and the
CLI's `profile --trace` writes them into its Chrome trace.

The `cuda` test runs each route on the card under
torch.cuda.set_sync_debug_mode("error"), which only host_read lifts: a
sync anywhere else fails it. This file imports no JAX, so that the card
runs it without the JAX-side conftest:

    python -m pytest tests/test_torch_timing.py --noconftest -m cuda
"""
import collections
import json
from typing import NamedTuple

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mpi_bicgstab_tpu_torch import api
from mpi_bicgstab_tpu_torch.benchmarks import sections
from mpi_bicgstab_tpu_torch.models.generators import banded_random
from mpi_bicgstab_tpu_torch.models.problem import build_problem
from mpi_bicgstab_tpu_torch.ops.cheby import ChebyPrecond
from mpi_bicgstab_tpu_torch.utils import timing
from mpi_bicgstab_tpu_torch.utils.config import ShiftedConfig, SolverConfig

torch.set_num_threads(1)

N = 2000
OFFSETS = [1, -1, 40, -40]      # a short band: few plain DF operations
ITERS = 3
ROUTES = ("fused-df32", "f64", "cheby-df32", "switching-df32")
# reads after a classic loop that stopped at max_iter short of tol:
# _restarted's history, converged, final_relres and true_relres
EXIT_READS = 4
# reads of the switching solve outside its iterations: the ladder's copy
# to the device and the stop flags' read before the loop
SWITCHING_READS = 2


def _route(name, device="cpu", n=N, iters=ITERS):
    """solve() of one route: stops at max_iter, tol out of reach."""
    if name == "switching-df32":
        prob = build_problem(banded_random(n, OFFSETS), dtype="df32",
                             multiple=1, device=device)
        sigma = (np.arange(8) + 1) * (0.01 / 8)
        cfg = ShiftedConfig(tol=1e-20, max_iter=iters, dtype="df32")
        return lambda: api.solve_shifted(
            prob.A, prob.b, sigma, seed=3,
            method="shifted_lopbicg_switching", cfg=cfg)
    dtype = torch.float64 if name == "f64" else "df32"
    prob = build_problem(banded_random(n, OFFSETS), dtype=dtype, multiple=1,
                         device=device)
    cfg = SolverConfig(tol=1e-20, max_iter=iters, restarts=2, dtype=dtype)
    pre = ChebyPrecond.parse("cheby:1:0.122:1220.0") \
        if name == "cheby-df32" else None
    return lambda: api.solve(prob.A, prob.b, cfg=cfg, precond=pre)


class Span(NamedTuple):
    name: str
    start: int
    end: int
    ancestors: tuple     # the mbt.* spans open around it, innermost first


def _traced(solve):
    """(result, its mbt.* spans) of one solve under a CPU profiler, read
    from the profiler's own events (one thread: the spans nest)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = solve()
    raw = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("mbt.")),
                 key=lambda t: (t[1], -t[2]))
    spans, open_ = [], []
    for name, a, b in raw:
        while open_ and open_[-1][2] < b:
            open_.pop()
        spans.append(Span(name, a, b,
                          tuple(o[0] for o in reversed(open_))))
        open_.append((name, a, b))
    return res, spans


def test_without_a_profiler_a_span_is_the_shared_no_op():
    assert timing.span("mbt.iter") is timing._OFF
    assert timing.host_read(torch.tensor(2.5)) == 2.5
    assert timing.host_read(lambda: "read") == "read"
    res, spans = _traced(lambda: timing.host_read(torch.tensor(1.0)))
    assert res == 1.0
    assert [(e.name, e.ancestors) for e in spans] == [("mbt.sync", ())]


@pytest.mark.parametrize("route", ROUTES)
def test_no_record_function_without_a_profiler(route, monkeypatch):
    solve = _route(route)

    def refuse(*a, **k):
        raise AssertionError("a RecordFunction was made with no profiler")
    monkeypatch.setattr(timing, "_RANGE", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert solve().n_iter == ITERS


@pytest.mark.parametrize("route", ROUTES)
def test_one_iteration_span_an_iteration(route):
    res, ev = _traced(_route(route))
    count = collections.Counter(e.name for e in ev)
    assert res.n_iter == ITERS and count["mbt.iter"] == ITERS
    assert count["mbt.solve"] == 1
    # no restart fires short of tol: one segment, none in a shifted solve
    assert count["mbt.segment"] == (route != "switching-df32")


@pytest.mark.parametrize("route", ROUTES)
def test_one_sync_an_iteration_and_the_exit_reads(route):
    res, ev = _traced(_route(route))
    syncs = [e for e in ev if e.name == "mbt.sync"]
    in_iter = [e for e in syncs if "mbt.iter" in e.ancestors]
    if route == "switching-df32":
        # the stop flags' read closes every iteration
        assert len(in_iter) == res.n_iter
        assert len(syncs) == res.n_iter + SWITCHING_READS
    else:
        # tol^2 (r0, r0) and the test before the first iteration, the
        # test closing each later one (at max_iter none is read), and
        # the exit's reads
        assert len(in_iter) == res.n_iter - 1
        assert len(syncs) == 2 + (res.n_iter - 1) + EXIT_READS


NESTING = {
    "fused-df32": [("mbt.sync", "mbt.iter", "mbt.segment", "mbt.solve")],
    "f64": [("mbt.launch.dia_spmv", "mbt.spmv", "mbt.iter", "mbt.segment",
             "mbt.solve"),
            ("mbt.dot", "mbt.iter", "mbt.segment", "mbt.solve")],
    "cheby-df32": [("mbt.launch.cheby_chain_df", "mbt.spmv", "mbt.iter",
                    "mbt.segment", "mbt.solve"),
                   ("mbt.launch.dia_spmv_df", "mbt.spmv", "mbt.spmv",
                    "mbt.iter", "mbt.segment", "mbt.solve")],
    "switching-df32": [("mbt.launch.dia_spmv_df", "mbt.spmv",
                        "mbt.seed_step", "mbt.iter", "mbt.solve"),
                       ("mbt.launch.fused_shift_update_df", "mbt.iter",
                        "mbt.solve"),
                       ("mbt.dot", "mbt.seed_step", "mbt.iter",
                        "mbt.solve")],
}


@pytest.mark.parametrize("route", ROUTES)
def test_spans_nest_from_the_solve_to_the_launches(route):
    """Inside an iteration every span sits in the chain of spans its
    layer gives it (on the CPU the fused passes run their plain twins,
    which launch nothing)."""
    res, ev = _traced(_route(route))
    for chain in NESTING[route]:
        inner = [e.ancestors for e in ev if e.name == chain[0]
                 and "mbt.iter" in e.ancestors]
        assert inner and set(inner) == {chain[1:]}, (chain, set(inner))
    recur = [e.ancestors for e in ev if e.name == "mbt.shift_recur"]
    assert set(recur) <= {("mbt.iter", "mbt.solve")}
    assert len(recur) == (res.n_iter if route == "switching-df32" else 0)


def test_profile_trace_holds_the_spans(tmp_path):
    """`profile --trace`'s Chrome trace of a tol=0 solve holds one
    mbt.iter span an iteration and the wrappers' launch spans."""
    path = sections.trace_solve(banded_random(N, OFFSETS), torch.float64,
                                ITERS, str(tmp_path), torch.device("cpu"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = collections.Counter(e["name"] for e in events
                                if e.get("name", "").startswith("mbt."))
    assert names["mbt.solve"] == 1 and names["mbt.iter"] == ITERS
    assert names["mbt.launch.dia_spmv"] == 2 * ITERS + 2
    assert names["mbt.sync"] == 0        # tol = 0 reads nothing


@pytest.mark.cuda
@pytest.mark.parametrize("route", ROUTES)
def test_on_the_card_every_sync_is_a_host_read(route, monkeypatch):
    """Every route's solve, restarts' reads and exit included, under the
    CUDA sync debug mode "error", which host_read alone lifts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    solve = _route(route, device="cuda", n=1 << 16, iters=8)
    solve()                 # loads the kernels and warms the route up
    read = timing._read

    def lifted(x):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return read(x)
        finally:
            torch.cuda.set_sync_debug_mode("error")
    monkeypatch.setattr(timing, "_read", lifted)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = solve()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert res.n_iter == 8
