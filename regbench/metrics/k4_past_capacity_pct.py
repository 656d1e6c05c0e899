"""Share of K4's scene tiles whose candidate count passed the table's
capacity, so that they folded every model tile: the program's
``k4_tiles_past_cap`` over ``k4_tiles``."""

from regbench.counters import program_counters, ratio


def read(run):
    c = program_counters(run)
    if not c:
        return None
    return ratio(c.get("k4_tiles_past_cap", 0), c.get("k4_tiles", 0), 100.0)
