"""(Scene row, model row) pairs K4's work items fold for each scene row it
searches, over the window's launches: the program's ``k4_pairs`` over
``k4_rows`` (both from each launch's candidate table)."""

from regbench.counters import program_counters, ratio


def read(run):
    c = program_counters(run)
    if not c:
        return None
    return ratio(c.get("k4_pairs", 0), c.get("k4_rows", 0))
