"""Share of the iterations the loops launched that the results do not
count: the gated no-ops after convergence within a chunk of launches
(``iters_launched`` against ``iters_done``, the program's counters)."""

from regbench.counters import program_counters, ratio


def read(run):
    c = program_counters(run)
    if not c:
        return None
    launched = c.get("iters_launched", 0)
    return ratio(launched - c.get("iters_done", 0), launched, 100.0)
