"""Symmetric-objective ICP (port of ``icp_tpu/engine/symmetric.py``;
Rusinkiewicz, SIGGRAPH 2019).

Minimises ``sum_i [(R p_i - R^-1 y_i + t) . (n_p_i + n_y_i)]^2``: the
residual is measured along the sum of the two matched normals and the
rotation is split between both clouds, which needs normals for both.  Per
iteration:

  * the matched model normal's sign is canonicalised against the scene
    normal, ``flip = -1 where n_p . n_y < 0`` (so sign(0) is +1), and the
    pair normal is ``n = n_p + flip n_y``;
  * Gauss-Newton over ``x = [a, t]`` with ``J_i = [(p_i + y_i) x n_i, n_i]``
    and the damped 6x6 solve of ``engine/point_to_plane.py``;
  * both half-rotations are folded onto the scene, ``R2 = R R``,
    ``t2 = R t``, so the model stays fixed; the scene normals co-rotate.

The reported error is the mean squared pair residual after the step: over
N in the dense loop, over the weight sum of the kd-padded rows in the grid
loop, as in JAX.

Two loops, as in JAX:
  * dense (``_icp_sym_dense``): NN by ``closest_point_indices`` (K1 for
    ``pallas``, K9 for ``bf16``), then the (y, n_y) gather;
  * grid (``_icp_sym_grid``): the model normals ride K4's payload slot; the
    scene normals are padded with the last normal and kd-permuted once with
    the points by ``_prepare_scene``'s ``perm``.

The loops stay on the device (``LoopState.record_on_device``, every update
gated by the done flag).  Rigid only; ``trim_fraction > 0``, bucket padding
and the sharded variant are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from icp_tpu_torch.config import ICPConfig
from icp_tpu_torch.engine.icp import LoopState, _validate, as_points
from icp_tpu_torch.engine.point_to_plane import _gated, _rodrigues, _solve6
from icp_tpu_torch.ops.alignment import Similarity
from icp_tpu_torch.ops.distance import closest_point_indices
from icp_tpu_torch.ops.transform import (
    apply_similarity,
    cast_similarity,
    compose,
    identity_similarity,
)
from icp_tpu_torch.utils.precision import in_full_float32


def _sym_step(p, pn, y, nv, w=None):
    """One symmetric Gauss-Newton step of matched (p, n_p, y, n_y), rows
    weighted by ``w`` (padding rows 0) -> (sim, p_new, pn_new, err)."""
    flip = torch.where((pn * nv).sum(1) < 0.0, -1.0, 1.0).to(p.dtype)
    n = pn + flip[:, None] * nv
    r = (n * (p - y)).sum(1)
    J = torch.cat([torch.linalg.cross(p + y, n, dim=1), n], dim=1)  # (N, 6)
    if w is not None:
        r = r * w
        J = J * w[:, None]
    x = _solve6(J.T @ J, J.T @ r)
    R = _rodrigues(x[:3])
    R2 = R @ R
    sim = Similarity(s=torch.ones((), dtype=p.dtype, device=p.device), R=R2, t=R @ x[3:])
    p_new = apply_similarity(p, sim)
    res = (n * (p_new - y)).sum(1)
    if w is None:
        err = (res * res).sum() / p.shape[0]
    else:
        res = res * w
        err = (res * res).sum() / w.sum()
    return sim, p_new, pn @ R2.T, err


def _icp_sym_dense(model, normals, scene, scene_normals, *, threshold: float,
                   max_iter: int, nn_method: str, init: Optional[Similarity], trace: bool):
    dt, dev = scene.dtype, scene.device
    p, pn = scene, scene_normals
    if init is not None:
        p, pn = apply_similarity(scene, init), scene_normals @ init.R.T
    total = identity_similarity(dt, dev) if init is None else init
    loop = LoopState(max_iter, max_iter, threshold, False, dev)

    def step():
        nonlocal p, pn, total
        idx = closest_point_indices(p, model, method=nn_method).to(torch.int64)
        sim, p_new, pn_new, err = _sym_step(p, pn, model[idx], normals[idx])
        done = loop.record_on_device(err)
        p = _gated(done, p, p_new)
        pn = _gated(done, pn, pn_new)
        total = _gated(done, total, compose(total, sim))

    loop.run(step)
    return loop.finish(p, total, dt, trace)


def _icp_sym_grid(model, normals, scene, scene_normals, *, threshold: float,
                  max_iter: int, scene_tile_target: int, model_tile_target: int,
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
        scene, scene_normals = apply_similarity(scene, init), scene_normals @ init.R.T
    grid = build_model_grid(model, target_tile=model_tile_target, payload=normals)
    p, w, inv_slots, tn, perm = _prepare_scene(scene, scene_tile_target)
    n_pad = p.shape[0] - scene.shape[0]
    pn = torch.cat([scene_normals, scene_normals[-1:].expand(n_pad, 3)])[perm]
    stride = max(1, min(16, model.shape[0] // 4))
    u = bound_from_indices(p, grid, initial_bound_indices(p, grid.model_orig, stride=stride))
    total = identity_similarity(dt, dev) if init is None else init
    loop = LoopState(max_iter, max_iter, threshold, False, dev)

    def step():
        nonlocal p, pn, u, total
        _, y, nv, _ = closest_point_indices_grid(p, grid, u, scene_tile=tn,
                                                 max_candidates=max_candidates)
        y, nv = y.to(dt), nv.to(dt)
        sim, p_new, pn_new, err = _sym_step(p, pn, y, nv, w)
        done = loop.record_on_device(err)
        u = _gated(done, u, next_bound(y, p_new))
        p = _gated(done, p, p_new)
        pn = _gated(done, pn, pn_new)
        total = _gated(done, total, compose(total, sim))

    loop.run(step)
    return loop.finish(p[inv_slots], total, dt, trace)


@in_full_float32
def icp_symmetric(model, scene, config: Optional[ICPConfig] = None, *,
                  normals=None, scene_normals=None, normal_k: int = 16, init=None,
                  trace: bool = False, device=None):
    """Register ``scene`` onto ``model`` with the symmetric plane objective.

    ``normals`` / ``scene_normals``: optional (M, 3) / (N, 3) unit normals,
    estimated by kNN PCA (``ops/normals.py``) when omitted.  The threshold
    applies to the mean squared symmetric residual (``n_p + n_y`` has
    length ~2 for agreeing normals, so it sits ~4x the point-to-plane
    error on the same alignment).  ``init``: warm-start Similarity with a
    pure rotation (the returned transform still maps the caller's scene).
    Every NN method: ``bcast``/``matmul``/``pallas``, the approximate
    ``bf16`` prefilter and ``grid``.  Returns ``ICPResult`` (``ICPTrace``
    with ``trace=True``); devices as in ``icp``.
    """
    from icp_tpu_torch.ops.normals import estimate_normals

    cfg = config or ICPConfig()
    if cfg.trim_fraction != 0.0:
        raise NotImplementedError("trimmed symmetric ICP (trim_fraction > 0) "
                                  "is not ported yet")
    model = as_points(model, cfg.dtype, device)
    scene = as_points(scene, cfg.dtype, model.device)
    _validate(model, scene, cfg)
    normals = (estimate_normals(model, k=normal_k) if normals is None
               else as_points(normals, cfg.dtype, model.device))
    scene_normals = (estimate_normals(scene, k=normal_k) if scene_normals is None
                     else as_points(scene_normals, cfg.dtype, model.device))
    if init is not None:
        init = cast_similarity(init, cfg.dtype, model.device)
    nn_method = cfg.resolved_nn_method(model.device.type,
                                       max(model.shape[0], scene.shape[0]))
    kw = dict(threshold=cfg.threshold, max_iter=cfg.max_iter, init=init, trace=trace)
    if nn_method == "grid":
        return _icp_sym_grid(model, normals, scene, scene_normals,
                             scene_tile_target=cfg.grid_scene_tile,
                             model_tile_target=cfg.grid_model_tile,
                             max_candidates=cfg.grid_max_candidates, **kw)
    return _icp_sym_dense(model, normals, scene, scene_normals, nn_method=nn_method, **kw)
