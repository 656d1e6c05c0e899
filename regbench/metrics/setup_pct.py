"""Share of the registrations' device time spent before their loops: the
device ms of the ``icp.prologue``, ``icp.normals.*`` and ``icp.setup.*``
spans over that of the ``icp.register`` spans (the program's counters;
device-timeline durations by CUDA events)."""

from regbench.counters import program_counters, ratio

_SETUP = ("icp.prologue", "icp.normals.", "icp.setup.")


def read(run):
    c = program_counters(run)
    if not c:
        return None
    ms = c.get("phase_ms", {})
    setup = sum(v for name, v in ms.items() if name.startswith(_SETUP))
    return ratio(setup, ms.get("icp.register", 0.0), 100.0)
