"""The statistics the end-to-end metrics use."""

from __future__ import annotations


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of ``values``, by linear interpolation
    between the closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
