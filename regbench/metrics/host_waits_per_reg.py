"""Blocking reads of the device by the host a registration: the program's
``host_waits`` over its ``registrations``."""

from regbench.counters import program_counters, ratio


def read(run):
    c = program_counters(run)
    if not c:
        return None
    return ratio(c.get("host_waits", 0), c.get("registrations", 0))
