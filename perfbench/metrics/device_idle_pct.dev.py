"""`device_idle_pct` in a cell whose end-to-end time is the card's
(`device_solve_s`): the same reading, moving that metric."""
from perfbench.spec import reader

UNIT = "%"
LAYER = "device (H100)"
MOVES = "device_solve_s"
read = reader("device_idle_pct").read
