"""Time to a solution that meets the cell's guarantee: the window's
seconds over the solves completed in it (host clock, set-up excluded)."""
UNIT = "s"


def read(run):
    if not run.solves:
        return None
    return run.window_s / len(run.solves)
