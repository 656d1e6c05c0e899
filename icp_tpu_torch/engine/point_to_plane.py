"""Point-to-plane ICP (port of ``icp_tpu/engine/point_to_plane.py``).

Minimises ``sum_i (n_i . (T p_i - y_i))^2``, the distance along the matched
model point's normal, over a rigid step: the Gauss-Newton normal equations
``A x = b`` of the 6-vector ``x = [omega, t]`` are sums of per-point outer
products, the 6x6 solve is a library call (``torch.linalg.solve_ex``: no
error check that would wait for the host), and the rotation is Rodrigues'
formula of ``omega``.  The reported error is the plain mean of the squared
plane residual after the step (no QUIRK-1 factor).

Two loops, as in JAX:
  * dense (``_icp_p2pl_dense``): NN by ``closest_point_indices`` (K1 for
    ``pallas``, the card's ``auto`` below ``GRID_AUTO_THRESHOLD``), then
    the (y, n) gather as a torch index;
  * grid (``_icp_p2pl_grid``): the normals ride in the model grid's payload
    slot, so K4 gives the matched point and its normal; the cull bound is
    the Euclidean ``||y - p_new||^2``.

The loop stays on the device: ``LoopState.record_on_device`` writes
``errs[it]``, the iteration count and the done flag with tensor ops, every
update is gated by the flag, and the host reads the flag once per chunk of
iterations.  Rigid only; ``trim_fraction > 0`` and the sharded variant are
not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from icp_tpu_torch.config import ICPConfig
from icp_tpu_torch.engine.icp import LoopState, _validate, as_points
from icp_tpu_torch.ops.alignment import Similarity
from icp_tpu_torch.ops.distance import closest_point_indices
from icp_tpu_torch.ops.transform import (
    apply_similarity,
    cast_similarity,
    compose,
    identity_similarity,
)
from icp_tpu_torch.utils.precision import in_full_float32

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


def _gauss_newton_step(p, y, nv, w=None) -> Similarity:
    """The rigid step minimising the linearised plane residual of (p, y, n),
    rows weighted by ``w`` (padding rows 0)."""
    r = (nv * (p - y)).sum(1)
    J = torch.cat([torch.linalg.cross(p, nv, dim=1), nv], dim=1)  # (N, 6)
    if w is not None:
        r = r * w
        J = J * w[:, None]
    x = _solve6(J.T @ J, J.T @ r)
    return Similarity(s=torch.ones((), dtype=p.dtype, device=p.device),
                      R=_rodrigues(x[:3]), t=x[3:])


def _solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The Gauss-Newton step ``x = -(A + damping I)^-1 b`` of a 6x6 system,
    with no error check that would wait for the host."""
    eye6 = torch.eye(6, dtype=A.dtype, device=A.device)
    return -torch.linalg.solve_ex(A + _DAMPING * eye6, b).result


def _gated(done: torch.Tensor, old, new):
    """``old`` where the loop is done, else ``new`` (tensors or Similarity)."""
    if isinstance(old, Similarity):
        return Similarity(*(torch.where(done, a, b) for a, b in zip(old, new)))
    return torch.where(done, old, new)


def _icp_p2pl_dense(model, normals, scene, *, threshold: float, max_iter: int,
                    nn_method: str, init: Optional[Similarity], trace: bool):
    dt, dev = scene.dtype, scene.device
    p = scene if init is None else apply_similarity(scene, init)
    total = identity_similarity(dt, dev) if init is None else init
    loop = LoopState(max_iter, max_iter, threshold, False, dev)
    n = p.shape[0]

    def step():
        nonlocal p, total
        idx = closest_point_indices(p, model, method=nn_method).to(torch.int64)
        y = model[idx]
        nv = normals[idx]
        sim = _gauss_newton_step(p, y, nv)
        p_new = apply_similarity(p, sim)
        err = ((nv * (p_new - y)).sum(1) ** 2).sum() / n
        done = loop.record_on_device(err)
        p = _gated(done, p, p_new)
        total = _gated(done, total, compose(total, sim))

    loop.run(step)
    return loop.finish(p, total, dt, trace)


def _icp_p2pl_grid(model, normals, scene, *, threshold: float, max_iter: int,
                   scene_tile_target: int, model_tile_target: int,
                   max_candidates: int, init: Optional[Similarity], trace: bool):
    from icp_tpu_torch.engine.grid import _prepare_scene
    from icp_tpu_torch.kernels.nn_grid import (
        bound_from_indices,
        build_model_grid,
        closest_point_indices_grid,
        initial_bound_indices,
        next_bound,
    )

    dt, dev = scene.dtype, scene.device
    if init is not None:
        scene = apply_similarity(scene, init)
    grid = build_model_grid(model, target_tile=model_tile_target, payload=normals)
    p, w, inv_slots, tn, _ = _prepare_scene(scene, scene_tile_target)
    stride = max(1, min(16, model.shape[0] // 4))
    u = bound_from_indices(p, grid, initial_bound_indices(p, grid.model_orig, stride=stride))
    total = identity_similarity(dt, dev) if init is None else init
    loop = LoopState(max_iter, max_iter, threshold, False, dev)
    w_sum = w.sum()

    def step():
        nonlocal p, u, total
        _, y, nv, _ = closest_point_indices_grid(p, grid, u, scene_tile=tn,
                                                 max_candidates=max_candidates)
        y, nv = y.to(dt), nv.to(dt)
        sim = _gauss_newton_step(p, y, nv, w)
        p_new = apply_similarity(p, sim)
        err = (((nv * (y - p_new)).sum(1) * w) ** 2).sum() / w_sum
        done = loop.record_on_device(err)
        u = _gated(done, u, next_bound(y, p_new))
        p = _gated(done, p, p_new)
        total = _gated(done, total, compose(total, sim))

    loop.run(step)
    return loop.finish(p[inv_slots], total, dt, trace)


@in_full_float32
def icp_point_to_plane(model, scene, config: Optional[ICPConfig] = None, *,
                       normals=None, normal_k: int = 16, init=None,
                       trace: bool = False, device=None):
    """Register ``scene`` onto ``model`` by the point-to-plane metric.

    ``normals``: optional (M, 3) model normals; estimated from the model by
    kNN PCA (``ops/normals.py``) when omitted.  The convergence threshold
    applies to the mean squared plane distance.  ``init``: warm-start
    Similarity (the returned transform still maps the caller's scene).
    Returns ``ICPResult`` (``ICPTrace`` with ``trace=True``).  Devices as in
    ``icp``: numpy input runs on the card unless ``device="cpu"``.
    """
    from icp_tpu_torch.ops.normals import estimate_normals

    cfg = config or ICPConfig()
    if cfg.trim_fraction != 0.0:
        raise NotImplementedError("trimmed point-to-plane ICP (trim_fraction > 0) "
                                  "is not ported yet")
    model = as_points(model, cfg.dtype, device)
    scene = as_points(scene, cfg.dtype, model.device)
    _validate(model, scene, cfg)
    if normals is None:
        normals = estimate_normals(model, k=normal_k)
    else:
        normals = as_points(normals, cfg.dtype, model.device)
    if init is not None:
        init = cast_similarity(init, cfg.dtype, model.device)
    nn_method = cfg.resolved_nn_method(model.device.type,
                                       max(model.shape[0], scene.shape[0]))
    kw = dict(threshold=cfg.threshold, max_iter=cfg.max_iter, init=init, trace=trace)
    if nn_method == "grid":
        return _icp_p2pl_grid(model, normals, scene,
                              scene_tile_target=cfg.grid_scene_tile,
                              model_tile_target=cfg.grid_model_tile,
                              max_candidates=cfg.grid_max_candidates, **kw)
    return _icp_p2pl_dense(model, normals, scene, nn_method=nn_method, **kw)
