"""Generalized-ICP, plane to plane (port of ``icp_tpu/engine/gicp.py``;
Segal et al.).

Each point carries a disk covariance ``C = I - (1 - eps) n n^T``, wide in its
tangent plane and ``eps`` along its normal.  The residual ``d = y - T p`` of
a match is weighted by ``M = (C_y + R C_p R^T)^-1``, and the 6-vector
Gauss-Newton step solves ``sum J^T M J x = sum J^T M d``.  The inverses are
closed-form adjugates (no batched LU per point on the card), the 6x6 system
is two matrix products over the (N*3, 6) rows, and the step is Rodrigues'
rotation, as in ``engine/point_to_plane.py``.  The reported error is the
mean Mahalanobis residual after the step (over N, or over the weight sum of
the kd-padded rows in the grid loop).

The loops are ``engine/plane.py``'s: dense (NN by
``closest_point_indices``, then the (y, n_y) gather; the scene covariances
co-rotate, ``C <- R C R^T``) and grid (the model normals ride K4's payload
slot; the scene covariances are kd-permuted once, with the identity on the
padding rows, weight 0); in both the step builds ``C_y`` from the matched
model normals.  Trim and bucket padding as in ``engine/point_to_plane.py``.
Under a profiler, GICP's own work lies in the inner span ``icp.gicp.step``
(``utils/profiling.inner``): each step (``C_y``, ``_gicp_system``) and each
rotation of the scene covariances, so twice a launched iteration, in the
single-device and the sharded loops alike (there with the step's
all-reduces), and once more for a warm start's rotation (``init``).

The 6x6 system is summed over the rows in float64, from the per-row
products in the cloud's dtype: at 1,000,000 rows (the ``horse1M.gicp``
benchmark cell, on an H100) float32 sums moved the answer by up to 4e-6 of
the model's diagonal, against 6e-7 with float64 sums.  The float32 per-row
products stand where JAX writes ``Precision.HIGHEST``: they need
full-float32 matmuls, which ``icp_generalized`` runs under
(``utils.precision.full_float32``).  Rigid only.
``icp_generalized_sharded`` is the multi-process form
(``parallel/sharded.gn_sharded``): the model normals ride the ring, the
scene's covariances are split with its rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from icp_tpu_torch.config import ICPConfig
from icp_tpu_torch.engine.icp import _validate, as_points
from icp_tpu_torch.engine.plane import PlaneEngine, run_plane
from icp_tpu_torch.engine.point_to_plane import _reduced, _rodrigues, _solve6
from icp_tpu_torch.ops.alignment import Similarity
from icp_tpu_torch.ops.transform import apply_similarity, cast_similarity
from icp_tpu_torch.utils.precision import in_full_float32
from icp_tpu_torch.utils.profiling import inner, register, span

STEP_SPAN = "icp.gicp.step"


def disk_covariances(normals: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """(N, 3) unit normals -> (N, 3, 3) plane-disk covariances
    ``I - (1 - eps) n n^T``."""
    eye = torch.eye(3, dtype=normals.dtype, device=normals.device)
    nnT = normals[:, :, None] * normals[:, None, :]
    return eye[None] - (1.0 - eps) * nnT


def _inv3_batched(M: torch.Tensor) -> torch.Tensor:
    """Closed-form inverses of (N, 3, 3) by adjugate / det; a determinant
    below 1e-30 in magnitude divides by 1 instead."""
    a, b, c = M[:, 0, 0], M[:, 0, 1], M[:, 0, 2]
    d, e, f = M[:, 1, 0], M[:, 1, 1], M[:, 1, 2]
    g, h, i = M[:, 2, 0], M[:, 2, 1], M[:, 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(det.abs() < 1e-30, torch.ones_like(det), det)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj * inv_det[:, None, None]


def _rotate_covariances(R: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """``R C_n R^T`` for every (3, 3) ``C_n``."""
    return R @ C @ R.T


def _gicp_system(p, y, Cy, cov_p, weights=None, reduce=None):
    """Residuals and the 6x6 normal equations of matched (p, y) under
    ``M = (C_y + C_p)^-1``, rows weighted by ``weights`` (padding rows 0)
    -> (sim, p_new, err); ``reduce``: the sums over the ranks of a sharded
    run."""
    dt, dev = p.dtype, p.device
    n = p.shape[0]
    M = _inv3_batched(Cy + cov_p)
    if weights is not None:
        M = M * weights[:, None, None]
    zeros = torch.zeros_like(p[:, 0])
    px = torch.stack([
        torch.stack([zeros, -p[:, 2], p[:, 1]], dim=-1),
        torch.stack([p[:, 2], zeros, -p[:, 0]], dim=-1),
        torch.stack([-p[:, 1], p[:, 0], zeros], dim=-1),
    ], dim=-2)  # [p]_x
    J = torch.cat([px, -torch.eye(3, dtype=dt, device=dev).expand(n, 3, 3)], dim=-1)
    # the per-row products in ``dt``, their sums over the rows in float64
    Jr = J.reshape(n * 3, 6).to(torch.float64)
    A = Jr.T @ (M @ J).reshape(n * 3, 6).to(torch.float64)
    b = Jr.T @ (M @ (y - p)[:, :, None]).reshape(n * 3).to(torch.float64)
    x = _solve6(*_reduced(reduce, A, b)).to(dt)
    sim = Similarity(s=torch.ones((), dtype=dt, device=dev), R=_rodrigues(x[:3]), t=x[3:])
    p_new = apply_similarity(p, sim)
    dn = y - p_new
    e = (dn * (M @ dn[:, :, None])[:, :, 0]).sum(1)
    if weights is None:
        return sim, p_new, e.sum() / n
    return sim, p_new, torch.div(*_reduced(reduce, e.sum(), weights.sum()))


def gicp_engine(eps: float) -> PlaneEngine:
    """The GICP part of the plane loops: each step builds the matched model
    rows' disk covariances from their normals, the scene side data is its
    covariances; the step and the rotation each lie in the inner span
    ``STEP_SPAN``."""

    def step(p, y, y_normals, cov_p, weights=None, reduce=None):
        with inner(STEP_SPAN, p):
            return _gicp_system(p, y, disk_covariances(y_normals, eps), cov_p, weights, reduce)

    def rotate(R, cov):
        with inner(STEP_SPAN, cov):
            return _rotate_covariances(R, cov)

    return PlaneEngine(
        step=step, rotate=rotate,
        pad=lambda cov, k: torch.eye(3, dtype=cov.dtype, device=cov.device).expand(k, 3, 3))


@in_full_float32
def icp_generalized(model, scene, config: Optional[ICPConfig] = None, *,
                    model_normals=None, scene_normals=None, normal_k: int = 16,
                    eps: float = 1e-3, init=None, trace: bool = False, scene_n=None,
                    model_n=None, device=None):
    """Generalized (plane-to-plane) ICP.

    Normals of both clouds are estimated by kNN PCA when not given; ``eps``
    is the across-surface variance (0: the pure plane metric, 1: point to
    point).  ``init``: warm-start Similarity with a pure rotation.  The
    step builds the matched model rows' covariances in ``config.dtype``;
    the grid loop carries the model normals as float32 payload, as JAX
    does.
    ``scene_n`` / ``model_n``: valid row counts of bucket-padded clouds.
    Returns ``ICPResult`` (``ICPTrace`` with ``trace=True``); devices as
    in ``icp``.
    """
    from icp_tpu_torch.ops.normals import estimate_normals

    where = model if device is None else device
    with register():
        with span("icp.prologue", where):
            cfg = config or ICPConfig()
            model = as_points(model, cfg.dtype, device)
            scene = as_points(scene, cfg.dtype, model.device)
            _validate(model, scene, cfg)
            if model_normals is not None:
                model_normals = as_points(model_normals, cfg.dtype, model.device)
            if scene_normals is not None:
                scene_normals = as_points(scene_normals, cfg.dtype, model.device)
            if init is not None:
                init = cast_similarity(init, cfg.dtype, model.device)
        if model_normals is None:
            model_normals = estimate_normals(model, k=normal_k)
        if scene_normals is None:
            scene_normals = estimate_normals(scene, k=normal_k)
        with span("icp.prologue", model):
            scene_cov = disk_covariances(scene_normals, eps)
        return run_plane(gicp_engine(eps), cfg, model, model_normals, scene, scene_cov,
                         init=init, trace=trace, scene_n=scene_n, model_n=model_n)


def icp_generalized_sharded(model, scene, config: Optional[ICPConfig] = None, *,
                            model_normals=None, scene_normals=None, normal_k: int = 16,
                            eps: float = 1e-3, mesh=None, trace: bool = False):
    """GICP with the scene and model rows split over the ranks of a
    ``points`` mesh, as ``icp_point_to_plane_sharded``; trimmed runs take
    the distributed quantile."""
    from icp_tpu_torch.parallel.sharded import gn_sharded

    return gn_sharded("gicp", model, scene, config, model_normals=model_normals,
                      scene_normals=scene_normals, normal_k=normal_k, eps=eps, mesh=mesh,
                      trace=trace)
