"""95th percentile latency of all the window's completed registrations, in
ms."""

from regbench.stats import percentile


def read(run):
    lat = run.window.latencies
    return 1e3 * percentile(lat, 95) if lat else None
