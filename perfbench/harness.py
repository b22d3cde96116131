"""One cell, driven through the program's public API: set-up, the closed
loop of whole solves, the traced stretch, and the check against the
plain reference.

Set-up builds the configuration's matrix with the program's generator
and `models.problem.build_problem` (the route `cli.run_solve` takes),
makes the traffic's fixed set of right-hand sides (its `rhs_seed`) with
the reference's own operator, and warms the route up with one short
solve of the same shapes. The window then runs cycles of that set back
to back, one caller, each cycle in an order drawn from --seed, for the
requested seconds; the cycle in flight at the deadline finishes and
counts. Every seed so gets the same work in another order: the
right-hand sides of a Transport-like system differ by a tenth in their
iterations, which a set drawn anew for each seed would put into the
spread of the times. With --trace 1 the traced stretch runs once the
window has closed and its peak memory has been read, so the window's
times are untraced. A cell whose end-to-end time is the card's
(`device_solve_s`) runs each cycle of its --trace 0 window under a
profile of the card alone, read in memory between cycles. Then, with
the program's state freed, the reference judges the answers: every
solve's x in a single-RHS cell, and every shift of the window's last
solve in a shifted cell (holding an earlier [S, n] answer would add a
whole state to the peak that the cell measures).

The precision, the method, the tolerance where it differs from the
configuration's, and a limit tighter than the configuration's guarantee
belong to the traffic: a lower precision has to read over the limit of
the precision the traffic states (PERF.md, the readings).
"""
from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import tracing
from perfbench.reference.generators import GENERATORS
from perfbench.reference.operator import DiaOperator, relres

HERE = Path(__file__).resolve().parent
TRACE_DIR = HERE / "traces"
CHECK_ROWS = 32          # shift rows the reference judges at once


@dataclasses.dataclass
class Record:
    """What a run measured, for the metric readers."""

    setup_s: float = math.nan
    build_s: float = math.nan
    window_s: float = math.nan
    setup_peak_bytes: int = 0
    window_peak_bytes: int = 0
    stretch_iters: int = 0     # iterations of the traced stretch
    window_busy_s: float = 0.0  # the card's busy time over the window
    window_traced: int = 0     # solves of the window under its profile
    window_ops: int = 0        # operations of the card in that profile
    solves: list = dataclasses.field(default_factory=list)
    trace: object = None       # tracing.Trace of the stretch, card only
    trace_host: object = None  # the same stretch, host and card
    shapes: dict = dataclasses.field(default_factory=dict)


def _seed_of(seed: int, k: int) -> int:
    """A generator seed for right-hand side k of the set `seed` draws."""
    return (int(seed) * 1_000_003 + 7919 * k + 1) % (2 ** 63)


def _degree(precond: str | None) -> int | None:
    if not precond:
        return None
    parts = precond.split(":")
    return int(parts[1]) if len(parts) > 1 else 8


class CellRun:
    """The program and the reference for one cell on one device.

    dtype overrides the traffic's precision (the control runs the
    program's float32 path); n overrides the configuration's size (the
    CPU rehearsal runs at a few thousand rows)."""

    def __init__(self, cell, device: str = "cuda", dtype: str | None = None,
                 n: int | None = None):
        self.config = cell.config
        self.traffic = cell.traffic
        self.dev = torch.device(device)
        self.dtype = dtype or self.traffic["dtype"]
        self.n_req = int(n or self.config["n"])
        self.shifted = self.traffic["entry"] == "solve_shifted"
        self.record = Record()
        self.kept = []            # (rhs index, answer) judged after the window
        self.card_trace = False   # profile the card through the window
        self.attempted = 0
        self.b_host, self.b_prog = [], []

    # --- set-up ------------------------------------------------------------

    def reference_operator(self) -> DiaOperator:
        gen = GENERATORS[self.config["generator"]]
        return DiaOperator.from_generator(gen, n=self.n_req,
                                          seed=self.config["matrix_seed"])

    def setup(self) -> None:
        """The program's kernels, matrix and operator, the right-hand
        sides and the warm-up (seeds other than the first reuse all but
        the right-hand sides: `use_seed`)."""
        from mpi_bicgstab_tpu_torch.models import generators
        from mpi_bicgstab_tpu_torch.models.problem import build_problem
        if self.dev.type == "cuda":
            from mpi_bicgstab_tpu_torch.ops import _build
            _build.build_all()
        self.ref = self.reference_operator()
        stated = (self.config["rows"], self.config["diagonals"],
                  self.config["band_entries"])
        got = (self.ref.n, self.ref.n_diags, self.ref.band_entries)
        if self.n_req == self.config["n"] and got != stated:
            raise RuntimeError(f"the reference's matrix has (rows, "
                               f"diagonals, band entries) {got}, the "
                               f"configuration states {stated}")
        S = self.config.get("sigma_len")
        self.record.shapes = {"n": self.ref.n, "n_diags": self.ref.n_diags,
                              "band_entries": self.ref.band_entries}
        if S:
            self.record.shapes["n_shifts"] = int(S)
            self.sigma = (np.arange(S) + 1) * (self.config["sigma_max"] / S)
            self.sigma_seed = int(self.config["sigma_seed"])
        if _degree(self.traffic.get("precond")):
            self.record.shapes["degree"] = _degree(self.traffic["precond"])
        t0 = time.perf_counter()
        csr = getattr(generators, self.config["generator"])(
            self.n_req, seed=self.config["matrix_seed"])
        self.prob = build_problem(csr, dtype=self._problem_dtype(),
                                  multiple=1, device=self.dev,
                                  format="auto")
        if self.prob.n != self.ref.n:
            raise RuntimeError(f"the program built {self.prob.n} rows, the "
                               f"reference {self.ref.n}")
        self._sync()
        self.record.build_s = time.perf_counter() - t0

    def make_rhs(self) -> None:
        """The traffic's fixed set of right-hand sides: x*_k near all-ones
        from a generator on the device seeded by the traffic's rhs_seed
        and k, b_k = (A + sigma_seed I) x*_k by the reference in float64;
        the program gets b_k in its own form."""
        from mpi_bicgstab_tpu_torch.ops.precision import df_from_f64
        t0 = time.perf_counter()
        t = self.traffic
        ref = self.ref.to(self.dev)
        self.b_host, self.b_prog = [], []
        for k in range(int(t["rhs_pool"])):
            g = torch.Generator(device=self.dev)
            g.manual_seed(_seed_of(t["rhs_seed"], k))
            u = torch.rand(ref.n, generator=g, dtype=torch.float64,
                           device=self.dev)
            x = 1.0 + float(t["rhs_spread"]) * (2.0 * u - 1.0)
            b = ref.matvec(x)
            if self.shifted:
                b = b + float(self.sigma[self.sigma_seed]) * x
            bh = b.cpu().numpy()
            self.b_host.append(bh)
            if self.dtype == "df32":
                self.b_prog.append(df_from_f64(bh, self.dev))
            else:
                self.b_prog.append(b.to(getattr(torch, self.dtype)))
        del ref
        self._sync()
        self.record.build_s += time.perf_counter() - t0

    def use_seed(self, seed: int, warm: bool = True) -> None:
        """The seed's order of the right-hand sides (each cycle of the
        window a new permutation of the set), and the warm-up solve."""
        if not self.b_prog:
            self.make_rhs()
        self.order = np.random.default_rng(seed)
        self.kept, self.attempted = [], 0
        self.record.solves = []
        if warm:
            prof = self._card_profiler()
            self._solve(0, iters=int(self.traffic["warmup_iters"]))
            self._sync()
            if prof:
                prof.stop()

    def _card_profiler(self):
        """With card_trace, a started profile of the card alone, read
        in memory and written nowhere; else None. The warm-up runs under
        one, so that the window's first cycle finds the profiler set
        up."""
        if not self.card_trace:
            return None
        prof = tracing.Profiler(False, None)
        prof.start()
        return prof

    def _problem_dtype(self):
        return "df32" if self.dtype == "df32" else getattr(torch, self.dtype)

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # --- the timed path ----------------------------------------------------

    def _solve(self, k: int, iters: int | None = None):
        from mpi_bicgstab_tpu_torch import api
        from mpi_bicgstab_tpu_torch.ops.cheby import ChebyPrecond
        from mpi_bicgstab_tpu_torch.utils.config import (ShiftedConfig,
                                                         SolverConfig)
        c, t = self.config, self.traffic
        b = self.b_prog[k % len(self.b_prog)]
        max_iter = int(iters or c["max_iter"])
        if self.shifted:
            cfg = ShiftedConfig(tol=self.tol, max_iter=max_iter,
                                dtype=self._problem_dtype())
            res = api.solve_shifted(self.prob.A, b, self.sigma,
                                    seed=self.sigma_seed, method=t["method"],
                                    cfg=cfg)
            return res, res.x_set, bool(res.stop_flags.all())
        cfg = SolverConfig(tol=self.tol, max_iter=max_iter,
                           restarts=int(c["restarts"]),
                           dtype=self._problem_dtype())
        pre = ChebyPrecond.parse(t["precond"]) if t.get("precond") else None
        res = api.solve(self.prob.A, b, method=t["method"], cfg=cfg,
                        precond=pre)
        return res, res.x, bool(res.converged)

    def window(self, seconds: float, trace: str | None = None) -> None:
        """Cycles of the whole set of right-hand sides, in the seed's
        order, until `seconds` have passed; the cycle in flight at the
        deadline finishes and counts. With trace (a name for the trace
        files), `stretch` runs once the window has closed and its peak
        memory has been read. With card_trace each cycle runs under a
        profile of the card alone, read between cycles, for the card's
        busy time over all of the window's solves."""
        rec = self.record
        if self.dev.type == "cuda":
            rec.setup_peak_bytes = torch.cuda.max_memory_allocated(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
        t_start = time.perf_counter()
        deadline = t_start + seconds
        while True:
            prof = self._card_profiler()
            for k in self.order.permutation(len(self.b_prog)).tolist():
                if self.shifted:
                    self.kept = []    # the last answer is the one judged
                self.attempted += 1
                t0 = time.perf_counter()
                res, x, conv = self._solve(k)
                self._sync()
                t1 = time.perf_counter()
                self.kept.append((k, x))
                rec.solves.append({"seconds": t1 - t0, "rhs": k,
                                   "n_iter": int(res.n_iter),
                                   "converged": conv})
                del res, x
            if prof:
                self._add_card_time(prof)
            if t1 >= deadline:
                break
        rec.window_s = t1 - t_start
        if self.dev.type == "cuda":
            rec.window_peak_bytes = torch.cuda.max_memory_allocated(self.dev)
        if trace:
            self.stretch(trace)

    def _add_card_time(self, prof) -> None:
        """Stop a cycle's profile of the card and add its busy time and
        solves to the window's. A cycle's profile that holds no operation
        of the card adds no solves, so the reader finds the window not
        wholly traced and reports nothing."""
        prof.stop()
        busy_s, ops = prof.card_busy()
        if busy_s > 0:
            self.record.window_busy_s += busy_s
            self.record.window_traced += len(self.b_prog)
            self.record.window_ops += ops

    def stretch(self, name: str) -> None:
        """A short steady stretch of the solver loop, twice: the cell's
        entry on its first right-hand side, stopped after the traffic's
        trace_iters iterations, under a profiler of the card alone (the
        card's busy time and kernel times) and under one of the host and
        the card (what the host did while the card idled). Not a solve:
        no answer of it is judged or counted, and it runs after the
        window, whose times and peak it leaves alone."""
        self._sync()
        for host in (False, True):
            prof = tracing.Profiler(host, TRACE_DIR / f"{name}.{host:d}.json")
            prof.start()
            res, _, _ = self._solve(0, iters=int(self.traffic["trace_iters"]))
            prof.stop()
            tr = tracing.load(prof.path)
            if host:
                self.record.trace_host = tr
            else:
                self.record.trace = tr
                self.record.stretch_iters = int(res.n_iter)
            del res

    # --- the check ---------------------------------------------------------

    def free_program(self) -> None:
        """Drop the program's operator and right-hand sides; the answers
        to judge stay."""
        self.prob = None
        self.b_prog = []
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> tuple[float, int, int]:
        """(largest true relative residual of any judged answer, answers
        over the guarantee, answers judged) under the reference, in
        float64; the largest is inf once an answer is not finite."""
        ref = self.ref.to(self.dev)
        worst, failed, judged = 0.0, 0, len(self.kept)
        for k, x in self.kept:
            b = torch.from_numpy(self.b_host[k % len(self.b_host)]).to(
                self.dev)
            r = self._relres(ref, x, b)
            bad = not math.isfinite(r) or r > self.limit
            failed += bad
            worst = max(worst, r) if math.isfinite(r) else math.inf
        self.kept = []
        return worst, failed, judged

    @property
    def tol(self) -> float:
        return float(self.traffic.get("tol", self.config["tol"]))

    @property
    def limit(self) -> float:
        """The configuration's guarantee, or the traffic's limit where
        that is tighter."""
        return min(float(self.config["guarantee"]["max_true_relres"]),
                   float(self.traffic.get("max_true_relres", math.inf)))

    def _relres(self, ref, x, b) -> float:
        if not self.shifted:
            return float(relres(ref, _f64(x), b))
        sig = torch.as_tensor(self.sigma, dtype=torch.float64,
                              device=self.dev)
        out = []
        for j0 in range(0, len(self.sigma), CHECK_ROWS):
            rows = slice(j0, j0 + CHECK_ROWS)
            xj = _f64(x[rows] if not hasattr(x, "hi")
                      else type(x)(x.hi[rows], x.lo[rows]))
            out.append(relres(ref, xj, b, sig[rows]))
        return float(torch.cat(out).max())


def _f64(x) -> torch.Tensor:
    """An answer in float64: a tensor as it is, a double-float pair as
    hi + lo (exact in float64)."""
    if hasattr(x, "hi"):
        return x.hi.to(torch.float64) + x.lo.to(torch.float64)
    return x.to(torch.float64)
