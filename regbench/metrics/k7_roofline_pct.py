"""K7's least time for the mix's ``k7_searches`` kNN searches a
registration, each of one cloud's rows among themselves, bytes only
(``roofline.k7_bound_s``, ``normal_k + 1`` neighbours a row), over its
plan, fold and merge device time a registration."""

from regbench import roofline


def read(run):
    tr = run.trace
    t = tr.family_seconds("K7") if tr is not None else 0.0
    if t <= 0 or not tr.registrations:
        return None
    m = int(tr.config["rows"])
    k = int(tr.mix["kwargs"]["normal_k"]) + 1
    searches = int(tr.mix["k7_searches"])
    return 100.0 * searches * roofline.k7_bound_s(m, m, k) / (t / len(tr.registrations))
