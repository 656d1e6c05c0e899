"""The program's own counters of a traced window, for the per-layer readers
that take them (``metrics/``): ``icp_tpu_torch.utils.profiling``'s
spans and counters, which move only while a ``torch.profiler`` records,
so over exactly the traced window.  A program without them gives None,
and so does an untraced run."""

from __future__ import annotations


def program_counters(run) -> dict | None:
    """``profiling.counters()`` after a traced window, or None."""
    if run.trace is None:
        return None
    try:
        from icp_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    return counters()


def ratio(num: float, den: float, scale: float = 1.0) -> float | None:
    """``scale * num / den``, or None where ``den`` is not above 0."""
    return scale * num / den if den > 0 else None
