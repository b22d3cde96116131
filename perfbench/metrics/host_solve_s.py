"""`solve_s` where the cell's end-to-end time is the card's
(`device_solve_s`): the window's seconds over the solves completed in it
(host clock, set-up excluded), read from the untraced window of a
--trace 1 run. The host's swings put it beyond any end-to-end bound
there; it shows what a change to the host loop gains."""
from perfbench.spec import reader

UNIT = "s"
LAYER = "solver loop"
MOVES = "device_solve_s"
read = reader("solve_s").read
