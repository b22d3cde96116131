"""Share of the solver loop's wall time in which no operation ran on the
card: 1 - (the card's busy time an iteration in the traced stretch, its
operations merged) / (the window's wall time an iteration, `iter_ms`).
The window's time leaves the profiler's own cost on the host out of the
share, and averages the host's swings over every iteration. Nothing
where no operation ran on a card."""
UNIT = "%"
LAYER = "device (H100)"
MOVES = "solve_s"


def read(run):
    tr = run.trace
    its = sum(s["n_iter"] for s in run.solves)
    if tr is None or tr.busy_s <= 0 or not run.stretch_iters or not its:
        return None
    busy = tr.busy_s / run.stretch_iters
    wall = sum(s["seconds"] for s in run.solves) / its
    return 100.0 * (1.0 - busy / wall)
