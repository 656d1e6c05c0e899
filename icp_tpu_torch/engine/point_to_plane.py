"""Point-to-plane ICP (port of ``icp_tpu/engine/point_to_plane.py``).

Minimises ``sum_i (n_i . (T p_i - y_i))^2``, the distance along the matched
model point's normal, over a rigid step: the Gauss-Newton normal equations
``A x = b`` of the 6-vector ``x = [omega, t]`` are sums of per-point outer
products, the 6x6 solve is a library call (``torch.linalg.solve_ex``: no
error check that would wait for the host), and the rotation is Rodrigues'
formula of ``omega``.  The reported error is the plain mean of the squared
plane residual after the step (no QUIRK-1 factor).

The loops are ``engine/plane.py``'s: dense (NN by
``closest_point_indices``, then the (y, n) gather) and grid (the normals
ride K4's payload slot; the cull bound is the Euclidean ``||y -
p_new||^2``).  Trimmed runs keep the best correspondences by Euclidean
distance, as every engine; bucket-padded runs (``scene_n``/``model_n``)
estimate the normals on the sentinel-padded model, where they are exact for
the real rows.  Rigid only.  ``icp_point_to_plane_sharded`` is the
multi-process form (``parallel/sharded.gn_sharded``).
"""

from __future__ import annotations

from typing import Optional

import torch

from icp_tpu_torch.config import ICPConfig
from icp_tpu_torch.engine.icp import _validate, as_points
from icp_tpu_torch.engine.plane import PlaneEngine, run_plane
from icp_tpu_torch.ops.alignment import Similarity
from icp_tpu_torch.ops.transform import apply_similarity, cast_similarity
from icp_tpu_torch.utils.precision import in_full_float32
from icp_tpu_torch.utils.profiling import register, span

_DAMPING = 1e-9


def _rodrigues(omega: torch.Tensor) -> torch.Tensor:
    """exp of the skew matrix of a rotation vector (3,) -> (3, 3)."""
    dt, dev = omega.dtype, omega.device
    theta = torch.sqrt(torch.clamp((omega * omega).sum(), min=1e-30))
    k = omega / theta
    zero = torch.zeros((), dtype=dt, device=dev)
    K = torch.stack([torch.stack([zero, -k[2], k[1]]),
                     torch.stack([k[2], zero, -k[0]]),
                     torch.stack([-k[1], k[0], zero])])
    eye = torch.eye(3, dtype=dt, device=dev)
    R = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    return torch.where(theta < 1e-12, eye, R)


def _gauss_newton_step(p, y, nv, w=None, reduce=None) -> Similarity:
    """The rigid step minimising the linearised plane residual of (p, y, n),
    rows weighted by ``w`` (padding rows 0); ``reduce``: the sums over the
    ranks of a sharded run (None: these rows are all of them)."""
    r = (nv * (p - y)).sum(1)
    J = torch.cat([torch.linalg.cross(p, nv, dim=1), nv], dim=1)  # (N, 6)
    if w is not None:
        r = r * w
        J = J * w[:, None]
    x = _solve6(*_reduced(reduce, J.T @ J, J.T @ r))
    return Similarity(s=torch.ones((), dtype=p.dtype, device=p.device),
                      R=_rodrigues(x[:3]), t=x[3:])


def _solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The Gauss-Newton step ``x = -(A + damping I)^-1 b`` of a 6x6 system,
    with no error check that would wait for the host."""
    eye6 = torch.eye(6, dtype=A.dtype, device=A.device)
    return -torch.linalg.solve_ex(A + _DAMPING * eye6, b).result


def _reduced(reduce, *sums):
    """``sums`` over the ranks by ``reduce`` (None: as they are)."""
    return sums if reduce is None else reduce(*sums)


def mean_sq(res: torch.Tensor, w=None, reduce=None) -> torch.Tensor:
    """Mean squared residual: over the rows, or of the ``w``-weighted
    residuals over ``w``'s sum (both summed by ``reduce`` over the ranks)."""
    if w is None:
        return (res * res).sum() / res.shape[0]
    res = res * w
    num, den = _reduced(reduce, (res * res).sum(), w.sum())
    return num / den


def _p2pl_step(p, y, nv, _, w, reduce=None):
    sim = _gauss_newton_step(p, y, nv, w, reduce)
    p_new = apply_similarity(p, sim)
    return sim, p_new, mean_sq((nv * (p_new - y)).sum(1), w, reduce)


POINT_TO_PLANE = PlaneEngine(step=_p2pl_step)


@in_full_float32
def icp_point_to_plane(model, scene, config: Optional[ICPConfig] = None, *,
                       normals=None, normal_k: int = 16, init=None,
                       trace: bool = False, scene_n=None, model_n=None, device=None):
    """Register ``scene`` onto ``model`` by the point-to-plane metric.

    ``normals``: optional (M, 3) model normals; estimated from the model by
    kNN PCA (``ops/normals.py``) when omitted.  The convergence threshold
    applies to the mean squared plane distance.  ``init``: warm-start
    Similarity (the returned transform still maps the caller's scene).
    ``scene_n`` / ``model_n``: valid row counts of bucket-padded clouds
    (pad rows at ``ops/padding.SENTINEL``).  Returns ``ICPResult``
    (``ICPTrace`` with ``trace=True``).  Devices as in ``icp``: numpy input
    runs on the card unless ``device="cpu"``.
    """
    from icp_tpu_torch.ops.normals import estimate_normals

    where = model if device is None else device
    with register():
        with span("icp.prologue", where):
            cfg = config or ICPConfig()
            model = as_points(model, cfg.dtype, device)
            scene = as_points(scene, cfg.dtype, model.device)
            _validate(model, scene, cfg)
            if normals is not None:
                normals = as_points(normals, cfg.dtype, model.device)
            if init is not None:
                init = cast_similarity(init, cfg.dtype, model.device)
        if normals is None:
            normals = estimate_normals(model, k=normal_k)
        return run_plane(POINT_TO_PLANE, cfg, model, normals, scene, init=init, trace=trace,
                         scene_n=scene_n, model_n=model_n)


def icp_point_to_plane_sharded(model, scene, config: Optional[ICPConfig] = None, *,
                               normals=None, normal_k: int = 16, mesh=None,
                               trace: bool = False):
    """Point-to-plane ICP with the scene and model rows split over the ranks
    of a ``points`` mesh (``parallel/mesh.make_mesh``): the ring fold with
    the model normals riding the ring, the 6x6 normal equations
    all-reduced and solved on every rank; an NN method resolving to
    ``"grid"`` takes the sharded kd-tile loop.  Every rank passes the same
    full clouds and gets the whole result; ``trace=True`` returns an
    ``ICPTrace``."""
    from icp_tpu_torch.parallel.sharded import gn_sharded

    return gn_sharded("point_to_plane", model, scene, config, model_normals=normals,
                      normal_k=normal_k, mesh=mesh, trace=trace)
