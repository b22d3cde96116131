"""Share of the roofline of kernel group cheby_df
(roofline/cheby_df.py): the least time of its traced launches at the
H100's published peaks over their traced time."""
from perfbench.roofline import share_pct

UNIT = "%"
LAYER = "kernels"
MOVES = "solve_s"


def read(run):
    if run.trace is None:
        return None
    return share_pct("cheby_df", run.shapes, run.trace.device)
