"""`host_syncs_per_iter` in a cell whose end-to-end time is the card's
(`device_solve_s`): the same reading, moving that metric."""
from perfbench.spec import reader

UNIT = "syncs/iter"
LAYER = "solver loop"
MOVES = "device_solve_s"
read = reader("host_syncs_per_iter").read
