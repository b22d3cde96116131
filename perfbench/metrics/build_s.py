"""The problem's build on the host: the program's generator, its
build_problem (layout, DF split, transfer) and the right-hand sides on
the card (host clock, a span of set-up)."""
UNIT = "s"
LAYER = "problem build (host)"
MOVES = "setup_s"


def read(run):
    return run.build_s
