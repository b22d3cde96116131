"""Share of the card's idle time in the traced stretch during which the
innermost program span on the host was a kernel wrapper's
`mbt.launch.*` (its checks, allocations and launch), split interval by
interval in the host-and-card profile (perfbench/spans.py). Nothing
without the program's spans or where no operation ran on a card."""
from perfbench import spans

UNIT = "%"
LAYER = "kernels"
MOVES = "solve_s"


def read(run):
    sp = spans.of_run(run)
    if sp is None or not sp.spans or run.trace_host.busy_s <= 0 \
            or sp.idle_s <= 0:
        return None
    return 100.0 * sp.idle_launch_s / sp.idle_s
