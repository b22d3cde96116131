"""Iterations a solve takes (the program's SolveResult / ShiftedResult
n_iter, restart segments included), the mean over the window's solves."""
UNIT = "iters"
LAYER = "solver loop"
MOVES = "solve_s"


def read(run):
    its = [s["n_iter"] for s in run.solves]
    return sum(its) / len(its) if its else None
