"""K7's least time for one kNN of the model's rows among themselves, bytes
only (``roofline.k7_bound_s``, ``normal_k + 1`` neighbours a row), over its
plan, fold and merge device time a registration."""

from regbench import roofline


def read(run):
    tr = run.trace
    t = tr.family_seconds("K7") if tr is not None else 0.0
    if t <= 0 or not tr.registrations:
        return None
    m = int(tr.config["rows"])
    k = int(tr.mix["kwargs"]["normal_k"]) + 1
    return 100.0 * roofline.k7_bound_s(m, m, k) / (t / len(tr.registrations))
