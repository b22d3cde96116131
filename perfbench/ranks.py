"""A cell across its `chips` ranks of the port's distributed route: what
`solve --devices P` runs (cli._run_solve_dist), one card a rank.

run.py hands a cell whose BENCHMARK.json entry asks for more than one
chip to `measure`. That starts P ranks with the program's own launcher
(parallel.launch.Pool: NCCL, one card a rank; gloo on the CPU for the
tests) and runs `rank_task` on every rank through launch.call_script, so
that a rank imports this file, the harness and the program, and nothing
of JAX (the Pool refuses a task after which a rank holds JAX).

Every rank, as the CLI's distributed route does, builds the
configuration's matrix with the program's generator, partitions it
(partition_csr, format "auto"), makes the row mesh and puts its own
shard on its card once, in set-up. It then solves with
solve_distributed over that shard, with the SolverConfig a one-chip
cell uses (harness.CellRun._solve: tol, max_iter, restarts, dtype) and
the traffic's method and preconditioner. Rank 0 makes the traffic's
fixed set of right-hand sides with the reference operator
(CellRun.make_rhs) and sends it to the others: every rank solves the
same b, handed over as the host vector the CLI hands over.

The window. Every rank draws the same order of each cycle from --seed.
The ranks meet before each solve; rank 0's host clock times it from
there to the return of the global x that solve_distributed gathers onto
every rank, once rank 0's card has finished. After each cycle rank 0
decides whether the deadline has passed and tells the others, outside
the timed solves, and every rank leaves the loop together. The ranks'
meetings and messages go over a gloo group of their own, on the hosts,
so that no operation of the harness runs on a card. The record is rank
0's (its solves, window and build seconds). setup_s runs from the start
of the process that prints the result (run.py's T_START) to rank 0's
window start, the ranks' spawn and process-group set-up inside it: both
ends are read from time.perf_counter, which on Linux is CLOCK_MONOTONIC,
one clock for every process of the machine. The peaks are the fullest
rank's: each rank reads its own at the window's start and end, as a
one-chip cell does, and rank 0 keeps the largest of each. A card profile
that a reader asks for (WINDOW_TRACE) and the --trace 1 stretch profile
rank 0's card and host alone, and rank 0 writes the stretch's trace
files: every reader reads rank 0's view of the run. A reader of the
program's spans has nothing true to read on this route, whose df32 loop
(solvers/fused_dist.py) opens no `mbt.iter` and whose exchanges and
NCCL waits open no span: spec.load_cell refuses such a metric in a cell
on several chips, and `synthetic` leaves it out.
device_solve_s counts rank 0's NCCL kernels as busy time, their waits
on the other ranks included.

The check. After the window rank 0 holds every kept answer, the global
x. The program's state is freed on every rank, and rank 0 judges each
answer against perfbench/reference in float64 as a one-chip cell does,
on the matrix's rows (the partition's padding rows left out).

    python3 perfbench/ranks.py --like hard-df32 --ranks 1 --seed <n> \
        --seconds <s> [--trace 1] [--against-one-device]

runs a cell of BENCHMARK.json on --ranks ranks of this route, whatever
its `chips`, under the name <cell>.ranks<P> (its metrics but those that
read the program's spans), and prints run.py's result
line. --against-one-device then solves each right-hand side once more on
one device through the one-chip route, in the same process once the
ranks have ended, and prints a line for each: its iterations on both
routes, and whether the two answers are equal bit for bit.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import dataclasses  # noqa: E402
import datetime  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import spec, tracing  # noqa: E402
from perfbench.harness import CellRun, _degree  # noqa: E402

PATH = str(Path(__file__).resolve())
DEVICE = "cuda"          # the ranks' device; the CPU tests set "cpu"


@dataclasses.dataclass
class Ranked:
    """Rank 0's account of a run, in the process that started the ranks:
    what run.py's result line and summary read of a run."""

    record: object          # harness.Record, rank 0's
    attempted: int
    limit: float
    checked: tuple          # (worst, failed, judged), as CellRun.check
    orders: list            # each rank's right-hand sides, in solve order
    answers: dict           # rhs -> its first answer, when asked for
    card_trace: bool = False


def _one_clock() -> None:
    """setup_s subtracts one process's perf_counter from another's."""
    impl = time.get_clock_info("perf_counter").implementation
    if "CLOCK_MONOTONIC" not in impl:
        raise RuntimeError(f"perf_counter is {impl}, not CLOCK_MONOTONIC: "
                           f"the ranks' clocks cannot be compared with "
                           f"this process's")


def run_ranks(config: dict, traffic: dict, n_ranks: int, seed: int,
              seconds: float, t_start: float, trace: str | None = None,
              card_trace: bool = False, answers: bool = False,
              task: tuple | None = None) -> Ranked:
    """Start n_ranks ranks, run one cell's whole run on them and stop
    them: rank 0's account. task: (script, function, *leading args) run
    on every rank in place of rank_task, with rank_task's arguments
    after the leading ones (the tests plant faults so)."""
    from mpi_bicgstab_tpu_torch.parallel import launch

    from perfbench import harness
    _one_clock()
    opts = {"seed": int(seed), "seconds": float(seconds), "trace": trace,
            "card_trace": bool(card_trace), "answers": bool(answers),
            "t_start": float(t_start), "trace_dir": str(harness.TRACE_DIR),
            "device": DEVICE}
    script, fn, *lead = task or (PATH, "rank_task")
    with launch.Pool(n_ranks, DEVICE) as pool:
        out = pool.run(launch.call_script, script, fn, *lead, config,
                       traffic, n_ranks, opts)
    return Ranked(card_trace=bool(card_trace), **out)


def run_cell(cell, args, t_start: float, answers: bool = False) -> Ranked:
    """run_ranks for a cell of BENCHMARK.json on cell.chips ranks, with
    run.py's arguments."""
    card_trace = any(getattr(m.reader, "WINDOW_TRACE", False) for m in
                     (cell.per_layer if args.trace else cell.end_to_end))
    return run_ranks(cell.config, cell.traffic, cell.chips, args.seed,
                     args.seconds, t_start,
                     trace=args.workload if args.trace else None,
                     card_trace=card_trace, answers=answers)


def measure(cell, args, t_start: float, report) -> int:
    """run.py's route for a cell on more than one chip: the run on its
    ranks, then report(...) ends it as run.py ends a one-chip run."""
    got = run_cell(cell, args, t_start)
    peak = max(got.record.setup_peak_bytes, got.record.window_peak_bytes)
    return report(cell, args, got, peak, *got.checked)


# --- on every rank ----------------------------------------------------------

def rank_task(config: dict, traffic: dict, n_ranks: int, opts: dict):
    """One rank's whole run: set-up, the window (with the stretch), the
    peaks, the program freed, the check. Rank 0 returns its account
    (Ranked's fields), the others None."""
    run = RankRun(config, traffic, n_ranks, opts)
    run.card_trace = opts["card_trace"]
    run.setup()
    run.use_seed(opts["seed"])
    run.window(opts["seconds"], trace=opts["trace"])
    answers = run.first_answers() if opts["answers"] else {}
    run.free_program()
    checked = run.check()
    if run.rank:
        return None
    return {"record": run.record, "attempted": run.attempted,
            "limit": run.limit, "checked": checked, "orders": run.orders,
            "answers": answers}


def _rank0_shapes(ref, n_loc: int, precond) -> dict:
    """The shapes of rank 0's work, which the roofline readers set
    against rank 0's kernels: its n_loc rows (the first of the matrix,
    with the partition's padding on one rank), the band's diagonals, the
    band's entries in those rows, and the preconditioner's degree."""
    rows = min(n_loc, ref.n)
    entries = sum(max(0, min(rows, ref.n - o) - max(0, -o))
                  for o in ref.offsets)
    shapes = {"n": n_loc, "n_diags": ref.n_diags, "band_entries": entries}
    if _degree(precond):
        shapes["degree"] = _degree(precond)
    return shapes


def _rows(x, n: int):
    """The first n rows of an answer (a tensor or a double-float pair)."""
    return type(x)(x.hi[:n], x.lo[:n]) if hasattr(x, "hi") else x[:n]


class RankRun(CellRun):
    """One rank's part of a cell: CellRun's set-up, window, stretch and
    check on the program's distributed route (module doc)."""

    def __init__(self, config: dict, traffic: dict, n_ranks: int,
                 opts: dict):
        import torch.distributed as dist
        from mpi_bicgstab_tpu_torch.parallel import launch
        dev = opts["device"]
        if dev == "cuda":        # the rank's own card, set by the launcher
            dev = f"cuda:{torch.cuda.current_device()}"
        super().__init__(types.SimpleNamespace(config=config,
                                               traffic=traffic), device=dev)
        self.rank = dist.get_rank()
        self.n_ranks = int(n_ranks)
        self.t_start = opts["t_start"]
        self.trace_dir = Path(opts["trace_dir"])
        self.orders = []          # right-hand sides in the order solved
        # the harness's own meetings and messages, on the hosts
        self.host = dist.new_group(backend="gloo", timeout=datetime.timedelta(
            seconds=launch.TIMEOUT_S))

    def _meet(self) -> None:
        """Every rank here, and this rank's card idle."""
        import torch.distributed as dist
        dist.barrier(group=self.host)
        self._sync()

    # --- set-up ------------------------------------------------------------

    def setup(self) -> None:
        """The kernels (built by rank 0 first), rank 0's reference
        operator, and on every rank the program's matrix, its partition,
        the row mesh and this rank's shard."""
        from mpi_bicgstab_tpu_torch.models import generators
        from mpi_bicgstab_tpu_torch.parallel.driver import put_partitioned
        from mpi_bicgstab_tpu_torch.parallel.mesh import make_row_mesh
        from mpi_bicgstab_tpu_torch.parallel.partition import partition_csr
        if self.dev.type == "cuda" and self.rank == 0:
            from mpi_bicgstab_tpu_torch.ops import _build
            _build.build_all()
        if self.rank == 0:
            self.ref = self.reference_operator()
            stated = (self.config["rows"], self.config["diagonals"],
                      self.config["band_entries"])
            got = (self.ref.n, self.ref.n_diags, self.ref.band_entries)
            if self.n_req == self.config["n"] and got != stated:
                raise RuntimeError(f"the reference's matrix has (rows, "
                                   f"diagonals, band entries) {got}, the "
                                   f"configuration states {stated}")
        self._meet()
        t0 = time.perf_counter()
        csr = getattr(generators, self.config["generator"])(
            self.n_req, seed=self.config["matrix_seed"])
        part = partition_csr(csr, self.n_ranks, dtype=self._problem_dtype(),
                             format="auto")
        self.n = part.n_logical
        if self.rank == 0 and self.n != self.ref.n:
            raise RuntimeError(f"the program built {self.n} rows, the "
                               f"reference {self.ref.n}")
        self.mesh = make_row_mesh(self.n_ranks)
        self.shard = put_partitioned(part, self.mesh)
        del csr, part
        if self.rank == 0:
            self.record.shapes = _rank0_shapes(self.ref, self.shard.n_loc,
                                               self.traffic.get("precond"))
        self._sync()
        self.record.build_s = time.perf_counter() - t0

    def make_rhs(self) -> None:
        """Rank 0 makes the set as a one-chip cell does; every rank gets
        it as host float64 vectors, which solve_distributed takes."""
        import torch.distributed as dist
        if self.rank == 0:
            super().make_rhs()
        t0 = time.perf_counter()
        K = int(self.traffic["rhs_pool"])
        B = torch.from_numpy(np.stack(self.b_host)) if self.rank == 0 \
            else torch.empty((K, self.n), dtype=torch.float64)
        dist.broadcast(B, src=0, group=self.host)
        self.b_host = list(B.numpy())
        self.b_prog = self.b_host
        self.record.build_s += time.perf_counter() - t0

    def _card_profiler(self):
        return super()._card_profiler() if self.rank == 0 else None

    # --- the timed path ----------------------------------------------------

    def _solve(self, k: int, iters: int | None = None):
        from mpi_bicgstab_tpu_torch.ops.cheby import ChebyPrecond
        from mpi_bicgstab_tpu_torch.parallel import driver
        from mpi_bicgstab_tpu_torch.utils.config import SolverConfig
        c, t = self.config, self.traffic
        cfg = SolverConfig(tol=self.tol, max_iter=int(iters or c["max_iter"]),
                           restarts=int(c["restarts"]),
                           dtype=self._problem_dtype())
        pre = ChebyPrecond.parse(t["precond"]) if t.get("precond") else None
        res = driver.solve_distributed(
            self.shard, self.b_prog[k % len(self.b_prog)], method=t["method"],
            cfg=cfg, mesh=self.mesh, precond=pre)
        return res, res.x, bool(res.converged)

    def window(self, seconds: float, trace: str | None = None) -> None:
        """CellRun.window across the ranks (module doc): rank 0 keeps the
        answers and the clock, and decides when the window closes."""
        import torch.distributed as dist
        rec = self.record
        if self.dev.type == "cuda":
            rec.setup_peak_bytes = torch.cuda.max_memory_allocated(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
        self._meet()
        t_start = time.perf_counter()
        rec.setup_s = t_start - self.t_start
        deadline = t_start + seconds
        while True:
            prof = self._card_profiler()
            for k in self.order.permutation(len(self.b_prog)).tolist():
                self.attempted += 1
                self._meet()
                t0 = time.perf_counter()
                res, x, conv = self._solve(k)
                self._sync()
                t1 = time.perf_counter()
                if self.rank == 0:
                    self.kept.append((k, x))
                self.orders.append(k)
                rec.solves.append({"seconds": t1 - t0, "rhs": k,
                                   "n_iter": int(res.n_iter),
                                   "converged": conv})
                del res, x
            if prof:
                self._add_card_time(prof)
            done = torch.tensor([int(t1 >= deadline)])
            dist.broadcast(done, src=0, group=self.host)
            if done.item():
                break
        rec.window_s = t1 - t_start
        if self.dev.type == "cuda":
            rec.window_peak_bytes = torch.cuda.max_memory_allocated(self.dev)
        self._gather_after_window()
        if trace:
            self.stretch(trace)

    def _gather_after_window(self) -> None:
        """The fullest rank's peaks into rank 0's record; every rank's
        order, which has to be one order."""
        import torch.distributed as dist
        rec = self.record
        peaks = torch.tensor([rec.setup_peak_bytes, rec.window_peak_bytes],
                             dtype=torch.int64)
        dist.all_reduce(peaks, op=dist.ReduceOp.MAX, group=self.host)
        rec.setup_peak_bytes, rec.window_peak_bytes = (int(v) for v in peaks)
        orders = [None] * self.n_ranks
        dist.all_gather_object(orders, self.orders, group=self.host)
        if any(o != orders[0] for o in orders):
            raise RuntimeError(f"the ranks solved the right-hand sides in "
                               f"different orders: {orders}")
        self.orders = orders

    def stretch(self, name: str) -> None:
        """CellRun.stretch with rank 0 alone profiled and writing the
        trace files; the others run the same solves beside it."""
        for host in (False, True):
            self._meet()
            prof = None
            if self.rank == 0:
                prof = tracing.Profiler(host,
                                        self.trace_dir / f"{name}.{host:d}.json")
                prof.start()
            res, _, _ = self._solve(0, iters=int(self.traffic["trace_iters"]))
            if prof:
                prof.stop()
                tr = tracing.load(prof.path)
                if host:
                    self.record.trace_host = tr
                else:
                    self.record.trace = tr
                    self.record.stretch_iters = int(res.n_iter)
            del res

    # --- the check ---------------------------------------------------------

    def first_answers(self) -> dict:
        """Rank 0's first answer to each right-hand side, on the matrix's
        rows."""
        out = {}
        for k, x in self.kept:
            out.setdefault(k, _rows(x, self.n))
        return out

    def free_program(self) -> None:
        self.shard = None
        super().free_program()

    def check(self):
        """CellRun.check on rank 0, over the matrix's rows of each global
        answer; None on the others."""
        if self.rank:
            self.kept = []
            return None
        self.kept = [(k, _rows(x, self.n)) for k, x in self.kept]
        return super().check()


# --- the entry --------------------------------------------------------------

def synthetic(like: str, n_ranks: int, bench: dict | None = None):
    """(name, benchmark): BENCHMARK.json (or bench) with one more cell,
    <like>.ranks<P>: `like`'s configuration, traffic and metrics, but
    those that read the program's spans (spec.reads_spans), on n_ranks
    chips."""
    bench = copy.deepcopy(bench or spec.load_benchmark())
    w = next((w for w in bench["workloads"] if w["name"] == like), None)
    if w is None:
        raise KeyError(f"unknown workload {like!r}")
    name = f"{like}.ranks{n_ranks}"
    bench["workloads"].append(dict(w, name=name, chips=int(n_ranks)))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", ()) \
                and not spec.reads_spans(spec.reader(m["name"])):
            m["workloads"].append(name)
    return name, bench


def same_as_one_device(cell, seed: int, got: Ranked) -> list:
    """Each right-hand side solved once on one device through the
    one-chip route: its iterations beside the ranks' first solve of it,
    and whether the two answers are equal bit for bit."""
    one = CellRun(cell, device=DEVICE)
    one.setup()
    one.use_seed(seed)
    lines = []
    for k, x in sorted(got.answers.items()):
        res, y, _ = one._solve(k)
        one._sync()
        mine = next(s["n_iter"] for s in got.record.solves if s["rhs"] == k)
        pairs = [(x.hi, y.hi), (x.lo, y.lo)] if hasattr(x, "hi") \
            else [(x, y)]
        equal = all(np.array_equal(np.asarray(a), b.cpu().numpy())
                    for a, b in pairs)
        lines.append({"rhs": k, "n_iter_ranks": mine,
                      "n_iter_one_device": int(res.n_iter),
                      "bit_equal": bool(equal)})
        del res, y
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--like", required=True,
                   help="the cell of BENCHMARK.json to run on --ranks ranks")
    p.add_argument("--ranks", type=int, required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--against-one-device", action="store_true")
    args = p.parse_args(argv)

    import run as run_py
    args.workload, bench = synthetic(args.like, args.ranks)
    cell = spec.load_cell(args.workload, bench)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < args.ranks:
        run_py.say(f"{args.workload} needs {args.ranks} CUDA device(s): "
                   f"nothing measured")
        return 2
    run_py.say(f"card: {run_py.power_limit()}; CUDA devices "
               f"{torch.cuda.device_count()}")
    got = run_cell(cell, args, T_START, answers=args.against_one_device)
    peak = max(got.record.setup_peak_bytes, got.record.window_peak_bytes)
    rc = run_py.report(cell, args, got, peak, *got.checked)
    if rc == 0 and args.against_one_device:
        for line in same_as_one_device(cell, args.seed, got):
            print(json.dumps({"same_as_one_device": line}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
