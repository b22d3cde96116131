"""Host syncs an iteration in the traced stretch: the program's
`mbt.sync` spans (utils/timing.host_read: every read of the solver loop
and its exits from the card) over its `mbt.iter` spans (one an
iteration), counted in the host-and-card profile (perfbench/spans.py).
Nothing without the program's spans."""
from perfbench import spans

UNIT = "syncs/iter"
LAYER = "solver loop"
MOVES = "solve_s"


def read(run):
    sp = spans.of_run(run)
    if sp is None or not sp.count(spans.ITER):
        return None
    return sp.count(spans.SYNC) / sp.count(spans.ITER)
