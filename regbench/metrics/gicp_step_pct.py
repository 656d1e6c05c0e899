"""Share of the registrations' device time spent in GICP's own step: the
device ms of the ``icp.gicp.step`` spans (each launched iteration's model
row covariances, Mahalanobis system, solve, moved points and error, and
the scene covariances' rotation) over that of the ``icp.register`` spans
(the program's counters; device-timeline durations by CUDA events).  None
where the program records no such span."""

from regbench.counters import program_counters, ratio

SPAN = "icp.gicp.step"


def read(run):
    c = program_counters(run)
    if not c or SPAN not in c.get("inner_ms", {}):
        return None
    return ratio(c["inner_ms"][SPAN], c.get("phase_ms", {}).get("icp.register", 0.0), 100.0)
