"""`idle_launch_pct` in a cell whose end-to-end time is the card's
(`device_solve_s`): the same reading, moving that metric."""
from perfbench.spec import reader

UNIT = "%"
LAYER = "kernels"
MOVES = "device_solve_s"
read = reader("idle_launch_pct").read
