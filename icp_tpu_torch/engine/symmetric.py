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

The loops are ``engine/plane.py``'s: dense (NN by
``closest_point_indices``, K1 for ``pallas``, K9 for ``bf16``, then the
(y, n_y) gather) and grid (the model normals ride K4's payload slot; the
scene normals are padded with the last normal and kd-permuted once with the
points).  Trim and bucket padding as in ``engine/point_to_plane.py``.
Rigid only.  ``icp_symmetric_sharded`` is the multi-process form
(``parallel/sharded.gn_sharded``): the scene normals are split with the
scene rows and co-rotate there, the model normals ride the ring.
"""

from __future__ import annotations

from typing import Optional

import torch

from icp_tpu_torch.config import ICPConfig
from icp_tpu_torch.engine.icp import _validate, as_points
from icp_tpu_torch.engine.plane import PlaneEngine, run_plane
from icp_tpu_torch.engine.point_to_plane import _reduced, _rodrigues, _solve6, mean_sq
from icp_tpu_torch.ops.alignment import Similarity
from icp_tpu_torch.ops.transform import apply_similarity, cast_similarity
from icp_tpu_torch.utils.precision import in_full_float32
from icp_tpu_torch.utils.profiling import register, span


def _sym_step(p, y, nv, pn, w=None, reduce=None):
    """One symmetric Gauss-Newton step of matched (p, y, n_y) with the scene
    normals ``pn``, rows weighted by ``w`` -> (sim, p_new, err); ``reduce``:
    the sums over the ranks of a sharded run."""
    flip = torch.where((pn * nv).sum(1) < 0.0, -1.0, 1.0).to(p.dtype)
    n = pn + flip[:, None] * nv
    r = (n * (p - y)).sum(1)
    J = torch.cat([torch.linalg.cross(p + y, n, dim=1), n], dim=1)  # (N, 6)
    if w is not None:
        r = r * w
        J = J * w[:, None]
    x = _solve6(*_reduced(reduce, J.T @ J, J.T @ r))
    R = _rodrigues(x[:3])
    sim = Similarity(s=torch.ones((), dtype=p.dtype, device=p.device), R=R @ R, t=R @ x[3:])
    p_new = apply_similarity(p, sim)
    return sim, p_new, mean_sq((n * (p_new - y)).sum(1), w, reduce)


def _rotate_normals(R, pn):
    return pn @ R.T


SYMMETRIC = PlaneEngine(step=_sym_step, rotate=_rotate_normals,
                        pad=lambda pn, k: pn[-1:].expand(k, 3))


@in_full_float32
def icp_symmetric(model, scene, config: Optional[ICPConfig] = None, *,
                  normals=None, scene_normals=None, normal_k: int = 16, init=None,
                  trace: bool = False, scene_n=None, model_n=None, device=None):
    """Register ``scene`` onto ``model`` with the symmetric plane objective.

    ``normals`` / ``scene_normals``: optional (M, 3) / (N, 3) unit normals,
    estimated by kNN PCA (``ops/normals.py``) when omitted.  The threshold
    applies to the mean squared symmetric residual (``n_p + n_y`` has
    length ~2 for agreeing normals, so it sits ~4x the point-to-plane
    error on the same alignment).  ``init``: warm-start Similarity with a
    pure rotation (the returned transform still maps the caller's scene).
    Every NN method: ``bcast``/``matmul``/``pallas``, the approximate
    ``bf16`` prefilter and ``grid``.  ``scene_n`` / ``model_n``: valid row
    counts of bucket-padded clouds.  Returns ``ICPResult`` (``ICPTrace``
    with ``trace=True``); devices as in ``icp``.
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
            if scene_normals is not None:
                scene_normals = as_points(scene_normals, cfg.dtype, model.device)
            if init is not None:
                init = cast_similarity(init, cfg.dtype, model.device)
        if normals is None:
            normals = estimate_normals(model, k=normal_k)
        if scene_normals is None:
            scene_normals = estimate_normals(scene, k=normal_k)
        return run_plane(SYMMETRIC, cfg, model, normals, scene, scene_normals, init=init,
                         trace=trace, scene_n=scene_n, model_n=model_n)


def icp_symmetric_sharded(model, scene, config: Optional[ICPConfig] = None, *,
                          normals=None, scene_normals=None, normal_k: int = 16, mesh=None,
                          trace: bool = False):
    """Symmetric ICP with the scene and model rows split over the ranks of
    a ``points`` mesh, as ``icp_point_to_plane_sharded``; the dense ring
    path checks the inputs as ``icp_symmetric`` does."""
    from icp_tpu_torch.parallel.sharded import gn_sharded

    return gn_sharded("symmetric", model, scene, config, model_normals=normals,
                      scene_normals=scene_normals, normal_k=normal_k, mesh=mesh,
                      trace=trace, validate=True)
