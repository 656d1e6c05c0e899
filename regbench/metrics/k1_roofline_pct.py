"""K1's least time for one dense search (``roofline.k1_bound_s``) over its
fold and epilogue device time an iteration, taken as K3's is."""

from regbench import roofline


def read(run):
    tr = run.trace
    t = tr.family_seconds("K1") if tr is not None else 0.0
    if t <= 0 or not tr.iterations:
        return None
    n = m = int(tr.config["rows"])
    return 100.0 * roofline.k1_bound_s(n, m) / (t / tr.iterations)
