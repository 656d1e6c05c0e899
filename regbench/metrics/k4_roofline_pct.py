"""K4's least time for one grid search, bytes only (``roofline.k4_bound_s``,
the mix's ``k4_payload_cols`` float32 columns a model row riding beside
the coordinates), over its near-tile, plan, fold and epilogue device time
an iteration, taken as K3's is."""

from regbench import roofline


def read(run):
    tr = run.trace
    t = tr.family_seconds("K4") if tr is not None else 0.0
    if t <= 0 or not tr.iterations:
        return None
    n = m = int(tr.config["rows"])
    payload = int(tr.mix["k4_payload_cols"])
    return 100.0 * roofline.k4_bound_s(n, m, payload) / (t / tr.iterations)
