"""K3's least time an iteration (``roofline.k3_bound_s``) over its device
time an iteration: all of K3's time in the traced window, the launches
after convergence included, over the window's iterations."""

from regbench import roofline


def read(run):
    tr = run.trace
    t = tr.family_seconds("K3") if tr is not None else 0.0
    if t <= 0 or not tr.iterations:
        return None
    n = m = int(tr.config["rows"])
    return 100.0 * roofline.k3_bound_s(n, m) / (t / tr.iterations)
