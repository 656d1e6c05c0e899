"""Similarity point-to-point ICP (``icp.point_to_point``): the reference
of the mixes whose entry is ``icp``.  The reported error is twice the mean
squared match distance while ``reference_compat`` holds (the reference
binary's), else the mean; ``trim_fraction`` > 0 keeps the trimmed set."""

from __future__ import annotations

from regbench.reference.icp import Answer, point_to_point


def answer(model, scene, icp: dict, kwargs: dict, *, precision: str,
           device) -> Answer:
    return point_to_point(
        model, scene, max_iter=int(icp["max_iter"]), threshold=float(icp["threshold"]),
        err_factor=2.0 if icp.get("reference_compat", True) else 1.0,
        trim_fraction=float(icp.get("trim_fraction", 0.0)), precision=precision, device=device)
