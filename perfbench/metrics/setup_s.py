"""Set-up: from the process's start (imports included) through the
kernels' build or load, the matrix, the operator, the right-hand sides
and the warm-up solve, to the window's start (host clock)."""
UNIT = "s"


def read(run):
    return run.setup_s
