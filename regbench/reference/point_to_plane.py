"""Rigid point-to-plane ICP (``icp.point_to_plane``): the reference of
the mixes whose entry is ``icp_point_to_plane``, the model's normals from
its ``kwargs["normal_k"] + 1`` nearest points."""

from __future__ import annotations

from regbench.reference.icp import Answer, point_to_plane


def answer(model, scene, icp: dict, kwargs: dict, *, precision: str,
           device) -> Answer:
    return point_to_plane(
        model, scene, max_iter=int(icp["max_iter"]), threshold=float(icp["threshold"]),
        normal_k=int(kwargs["normal_k"]), precision=precision, device=device)
