"""Run one cell of BENCHMARK.json on the card and print one JSON line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

--trace 0 reports the cell's end-to-end metrics, --trace 1 its per-layer
metrics and a breakdown of a traced stretch run after the window. Every run
checks the answers of its window against the plain reference and prints
each number compared beside its limit, last in the result line and as
the last lines of standard error. Without a CUDA card (or with fewer
than the cell asks for) it exits 2 and prints no result. A cell on more
than one chip runs across its ranks of the program's distributed route
(perfbench/ranks.py) and ends as a one-chip cell does (`report`).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

PROGRAM = "mpi_bicgstab_tpu_torch"
# top-level module names that may not be loaded in the measuring process
FORBIDDEN = ("jax", "jaxlib", "flax", "mpi_bicgstab_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def say(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def metrics_of(cell, run, trace: bool) -> dict:
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.reader.read(run.record)
        if v is not None:
            out[m.name] = {"value": v, "unit": m.unit}
    return out


def result(cell, run, trace: bool, dev: dict, worst: float,
           failed: int, judged: int) -> dict | None:
    """The run's result line: correct, attempted, failed, the metrics of
    the mode, device, with trace the breakdown, and last the numbers
    compared, each beside its limit (None: a traced stretch is
    missing). A run that judged no answer is not correct."""
    line = {"correct": False, "attempted": run.attempted, "failed": failed,
            "metrics": metrics_of(cell, run, trace), "device": dev}
    if trace:
        tr, th = run.record.trace, run.record.trace_host
        if tr is None or th is None:
            return None
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        line["breakdown"] = {"device_ops": tr.device_ops(),
                             "idle_gaps": th.idle_gaps()}
    ok = math.isfinite(worst) and worst <= run.limit
    line["correct"] = bool(ok and failed == 0 and judged > 0
                           and run.attempted > 0)
    line["checks"] = {"max_true_relres": {
        "value": worst if math.isfinite(worst) else None,
        "limit": run.limit}}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from perfbench import spec
    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        say(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" present: nothing measured")
        return 2
    import mpi_bicgstab_tpu_torch as program
    if ROOT not in Path(program.__file__).resolve().parents:
        say(f"{PROGRAM} was imported from {program.__file__}, outside "
            f"this checkout ({ROOT}): nothing measured")
        return 1
    torch.set_num_threads(4)
    from perfbench.harness import CellRun

    say(f"card: {power_limit()}")
    if cell.chips > 1:
        from perfbench import ranks
        return ranks.measure(cell, args, T_START, report)
    run = CellRun(cell)
    run.card_trace = any(getattr(m.reader, "WINDOW_TRACE", False) for m in
                         (cell.per_layer if args.trace else cell.end_to_end))
    run.setup()
    run.use_seed(args.seed)
    run.record.setup_s = time.perf_counter() - T_START
    run.window(args.seconds, trace=args.workload if args.trace else None)
    peak = max(run.record.setup_peak_bytes, run.record.window_peak_bytes)
    run.free_program()
    worst, failed, judged = run.check()
    return report(cell, args, run, peak, worst, failed, judged)


def report(cell, args, run, peak, worst, failed, judged) -> int:
    """The end of a measured run, on one chip or across ranks (`run` is
    a CellRun or a ranks.Ranked): the guard against JAX, the summary on
    standard error, the result line, and the numbers compared."""
    import torch
    gone = forbidden_modules()
    if gone:
        say(f"the measuring process loaded {gone}: no result")
        return 3
    secs = [s["seconds"] for s in run.record.solves]
    say(f"{args.workload} seed {args.seed}: {len(secs)} solves, right-hand "
        f"sides {[s['rhs'] for s in run.record.solves]}, n_iter "
        f"{[s['n_iter'] for s in run.record.solves]}, seconds {secs}, "
        f"p50 {statistics.median(secs)} max {max(secs)}, unconverged "
        f"{sum(not s['converged'] for s in run.record.solves)}, setup_s "
        f"{run.record.setup_s}, build_s {run.record.build_s}")
    if run.card_trace:
        its = sum(s["n_iter"] for s in run.record.solves)
        say(f"the card's profile of the window: busy_s "
            f"{run.record.window_busy_s} over {run.record.window_traced} of "
            f"{len(secs)} solves, {run.record.window_ops} operations "
            f"({run.record.window_ops / max(its, 1)} an iteration)")
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    line = result(cell, run, bool(args.trace), dev, worst, failed, judged)
    if line is None:
        say("a traced stretch left no trace: no result")
        return 4
    print(json.dumps(line), flush=True)
    for name, c in line["checks"].items():
        say(f"check {name} {c['value']} limit {c['limit']} (answers over "
            f"it: {failed} of {judged} judged)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
