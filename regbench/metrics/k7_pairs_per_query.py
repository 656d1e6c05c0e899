"""(Query, model row) pairs K7's work items fold for each query row, over
both launches of each kNN (seed and exact pass): the program's
``k7_pairs`` over ``k7_rows``."""

from regbench.counters import program_counters, ratio


def read(run):
    c = program_counters(run)
    if not c:
        return None
    return ratio(c.get("k7_pairs", 0), c.get("k7_rows", 0))
