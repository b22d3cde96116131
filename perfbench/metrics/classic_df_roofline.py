"""Share of the roofline of kernel group classic_df
(roofline/classic_df.py): the least time of its traced launches at the
H100's published peaks over their traced time."""
from perfbench.roofline import share_pct

UNIT = "%"
LAYER = "kernels"
MOVES = "device_solve_s"


def read(run):
    if run.trace is None:
        return None
    return share_pct("classic_df", run.shapes, run.trace.device)
