"""Share of K4's work items that its fold skipped because every point of
the scene tile held a best nearer than the item's model-tile box: the
program's ``k4_items_skipped`` over ``k4_items`` (each launch's fold list,
its near pass included).  A program that counts no ``k4_items`` gives
None."""

from regbench.counters import program_counters, ratio


def read(run):
    c = program_counters(run)
    if not c:
        return None
    return ratio(c.get("k4_items_skipped", 0), c.get("k4_items", 0), 100.0)
