"""The GICP step's least time over its device time (the ``icp.gicp.step``
spans' device ms, the program's counters), over every launched iteration
of the window (``iters_launched``: the step runs in each, no-ops
included).

The least time is bytes only, at the card's memory rate
(``roofline.HBM_BYTES_PER_S``), for the configuration's ``rows`` real
scene rows (kd padding is the program's choice): ``ROW_BYTES`` = 76 a row
and iteration, the step's inputs and outputs whatever implements it.  It
reads the scene point, its match, the match's normal, the scene row's
normal and its weight (13 float32) and writes the moved point and the
rotated normal (6 float32).  Its ~400 float32 operations a row (the two
disk covariances, the closed-form 3x3 inverse, the row's share of the 6x6
system and of the 6-vector, the moved point, the Mahalanobis error, the
rotated covariance) take under a third of the bytes' time at the card's
float32 peak.  None where the program records no such span."""

from regbench import roofline
from regbench.counters import program_counters

SPAN = "icp.gicp.step"
ROW_BYTES = 4 * (13 + 6)


def read(run):
    c = program_counters(run)
    if not c or SPAN not in c.get("inner_ms", {}):
        return None
    seconds = 1e-3 * c["inner_ms"][SPAN]
    launched = c.get("iters_launched", 0)
    if seconds <= 0 or launched <= 0:
        return None
    least = launched * roofline.bound_s(0, ROW_BYTES * int(run.trace.config["rows"]))
    return 100.0 * least / seconds
