"""The readings a cell's correctness limit is set from, many seeds in one
process: the program's own (lower reading) and the control's, the
program in a lower precision than the cell states (upper reading). One
set-up serves every seed: the matrix and the operator are built once.

    python3 perfbench/readings.py --workload hard-df32 \
        --seeds 11,12,13 --seconds 30 [--rhs-seeds 0,1,2] \
        [--dtype float32] [--out FILE]

A run of the cell solves its traffic's fixed set of right-hand sides
(`rhs_seed`) in an order drawn from --seed, so every seed judges the same
answers. --rhs-seeds reads other sets as well, each with every seed, to
show how far the number compared moves when the answers change: a set
drawn anew is what a sound change to the program's rounding amounts to
on a system that needs thousands of iterations.

Each (set, seed) prints one JSON line: the number compared (the largest
true relative residual of the answers judged), the answers over the
limit, and each solve's iterations and seconds. The benchmark's own runs
never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def read(workload: str, seeds, seconds: float, rhs_seeds=(None,),
         dtype: str | None = None, out=None, device: str = "cuda",
         n: int | None = None):
    """Yield one line (a dict) per right-hand-side set and seed; None in
    rhs_seeds is the traffic's own set. device and n are for the CPU
    tests, which read at a few hundred rows."""
    from perfbench import spec
    from perfbench.harness import CellRun
    cell = spec.load_cell(workload)
    run = CellRun(cell, device=device, dtype=dtype, n=n)
    t0 = time.perf_counter()
    run.setup()
    own = cell.traffic["rhs_seed"]
    for j, rs in enumerate(rhs_seeds):
        cell.traffic["rhs_seed"] = own if rs is None else int(rs)
        run.b_prog = []
        for i, seed in enumerate(seeds):
            run.use_seed(seed, warm=(i == 0 and j == 0))
            if i == 0 and j == 0:
                print(f"set-up {time.perf_counter() - t0:.3f} s",
                      file=sys.stderr)
            run.window(seconds)
            worst, failed, judged = run.check()
            solves = run.record.solves
            yield {"workload": workload, "seed": seed,
                   "rhs_seed": cell.traffic["rhs_seed"],
                   "dtype": run.dtype, "value": worst, "limit": run.limit,
                   "failed": failed, "judged": judged,
                   "window_s": run.record.window_s,
                   "peak_bytes": run.record.window_peak_bytes,
                   "n_iter": [s["n_iter"] for s in solves],
                   "seconds": [s["seconds"] for s in solves],
                   "converged": [s["converged"] for s in solves]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rhs-seeds", default=None,
                   help="other sets of right-hand sides to read as well")
    p.add_argument("--dtype", default=None,
                   help="a lower precision than the cell's: the control")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: nothing read", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    seeds = [int(s) for s in args.seeds.split(",")]
    sets = [None] + ([int(s) for s in args.rhs_seeds.split(",")]
                     if args.rhs_seeds else [])
    out = open(args.out, "a") if args.out else None
    for line in read(args.workload, seeds, args.seconds, sets, args.dtype):
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
