"""Milliseconds per iteration: the window's solves' host seconds over all
their iterations."""
UNIT = "ms"
LAYER = "solver loop"
MOVES = "solve_s"


def read(run):
    its = sum(s["n_iter"] for s in run.solves)
    return 1e3 * sum(s["seconds"] for s in run.solves) / its if its else None
