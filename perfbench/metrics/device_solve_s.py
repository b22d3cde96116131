"""The card's time to a solution: its busy time (operations merged) over
the whole window, read from a profile of the card alone that covers
every cycle, over the solves completed in it. Where the host's swings
move the wall time of a host-paced loop by more than a bound can hold,
this is the cell's end-to-end time: it moves with each kernel's time and
with the iterations a solve takes, not with the host. Nothing unless
every solve of the window was traced on a card."""
UNIT = "s"
WINDOW_TRACE = True


def read(run):
    n = len(run.solves)
    if not n or run.window_busy_s <= 0 or run.window_traced != n:
        return None
    return run.window_busy_s / n
