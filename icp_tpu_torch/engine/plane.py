"""The Gauss-Newton loops the three plane-metric engines share, and the one
engine dispatch of the package.

Point-to-plane, symmetric and GICP (``engine/point_to_plane.py``,
``engine/symmetric.py``, ``engine/gicp.py``) differ only in their step and
their side data; this module runs either loop for each of them:

  * ``dense_loop``: NN by ``closest_point_indices`` (K1 for ``pallas``, K9
    for ``bf16``), the gather of the matched model points and their
    normals, the trim and bucket weights (``engine/icp.step_weights``),
    the engine's step, the gated update;
  * ``grid_loop``: the model normals ride K4's payload slot, the scene's
    side data (scene normals, covariances) is padded and kd-permuted once
    with the points, the trim reads K4's distances
    (``engine/grid.grid_weights``) and the cull bound is the Euclidean
    ``||y - p_new||^2``.

Both replica-fill bucket-padded clouds first (``bucket_prologue``); the
normals were estimated before, on the sentinel-padded clouds, where they
are exact for the real rows.  The loops stay on the device:
``LoopState.record_on_device`` writes the error, the count and the done
flag with tensor ops, every update is gated by the flag, and the host
reads it once per chunk of iterations.

``run_engine`` is the dispatch by the CLI's ``--engine`` names, for the
CLI, ``chip_smoke.py`` and the tests.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from icp_tpu_torch.config import grid_sizes
from icp_tpu_torch.engine.icp import LoopState, bucket_prologue, step_weights, true_count
from icp_tpu_torch.ops.alignment import Similarity
from icp_tpu_torch.ops.distance import closest_point_indices
from icp_tpu_torch.ops.transform import apply_similarity, compose, identity_similarity
from icp_tpu_torch.utils.profiling import span

ENGINES = ("point_to_point", "point_to_plane", "symmetric", "gicp")


class PlaneEngine(NamedTuple):
    """One engine's part of the loops.

    ``step(p, y, y_normals, s_side, w) -> (sim, p_new, err)``: one
    Gauss-Newton step of the matched points ``y`` with their model normals
    and the scene's own side rows ``s_side``, rows weighted by ``w`` (None:
    unweighted).  ``rotate(R, s_side)``: the scene side data moved by a
    rotation (None: the engine has none).  ``pad(s_side, k)``: ``k`` rows of
    scene side data for the kd tile padding (weight 0)."""

    step: Callable
    rotate: Optional[Callable] = None
    pad: Optional[Callable] = None


def _gated(done: torch.Tensor, old, new):
    """``old`` where the loop is done, else ``new`` (tensors or Similarity)."""
    if isinstance(old, Similarity):
        return Similarity(*(torch.where(done, a, b) for a, b in zip(old, new)))
    return torch.where(done, old, new)


def _start(engine: PlaneEngine, scene, s_side, init: Optional[Similarity]):
    if init is None:
        return scene, s_side
    return (apply_similarity(scene, init),
            None if s_side is None else engine.rotate(init.R, s_side))


def _advance(engine, loop, state: dict, sim, p_new, err, **more):
    """Record ``err`` and gate every update of ``state`` (p, side, total
    and the ``more`` entries) by the done flag before it."""
    done = loop.record_on_device(err)
    new = dict(more, p=p_new, total=compose(state["total"], sim))
    if state["side"] is not None:
        new["side"] = engine.rotate(sim.R, state["side"])
    for k, v in new.items():
        state[k] = _gated(done, state[k], v)


def dense_loop(engine: PlaneEngine, model, normals, scene, s_side, *, threshold: float,
               max_iter: int, nn_method: str, init: Optional[Similarity], trace: bool,
               trim_fraction: float = 0.0, scene_n=None, model_n=None):
    """The dense loop of a plane engine: the model ``normals`` gathered with
    the matched points, ``s_side`` the scene's (N, ...) side data or None."""
    dt, dev = scene.dtype, scene.device
    with span("icp.prologue", dev):
        model, scene, mask = bucket_prologue(model, scene, scene_n, model_n)
        p, side = _start(engine, scene, s_side, init)
        state = dict(p=p, side=side,
                     total=identity_similarity(dt, dev) if init is None else init)
        loop = LoopState(max_iter, max_iter, threshold, False, dev)

    def step():
        p = state["p"]
        idx = closest_point_indices(p, model, method=nn_method).to(torch.int64)
        y = model[idx]
        w = step_weights(p, y, trim_fraction, mask)
        sim, p_new, err = engine.step(p, y, normals[idx], state["side"], w)
        _advance(engine, loop, state, sim, p_new, err)

    loop.run(step)
    with span("icp.finish", dev):
        return loop.finish(state["p"], state["total"], dt, trace)


def grid_loop(engine: PlaneEngine, model, normals, scene, s_side, *, threshold: float,
              max_iter: int, scene_tile_target, model_tile_target,
              max_candidates, init: Optional[Similarity], trace: bool,
              trim_fraction: float = 0.0, scene_n=None, model_n=None):
    """The grid loop of a plane engine: the model ``normals`` are K4's
    payload, ``s_side`` the scene's (N, ...) side data or None; sizes left
    None are the device's (``config.grid_sizes``)."""
    from icp_tpu_torch.engine.grid import _prepare_scene, grid_weights, seed_bounds
    from icp_tpu_torch.kernels.nn_grid import (
        build_model_grid,
        closest_point_indices_grid,
        next_bound,
    )

    dt, dev = scene.dtype, scene.device
    with span("icp.prologue", dev):
        scene_tile_target, model_tile_target, max_candidates = grid_sizes(
            dev, scene_tile_target, model_tile_target, max_candidates)
        model, scene, _ = bucket_prologue(model, scene, scene_n, model_n)
        scene, s_side = _start(engine, scene, s_side, init)
    with span("icp.setup.model_grid", dev):
        grid = build_model_grid(model, target_tile=model_tile_target, payload=normals)
    with span("icp.setup.scene_sort", dev):
        p, w, inv_slots, tn, perm = _prepare_scene(scene, scene_tile_target, n_valid=scene_n)
        if s_side is not None:
            s_side = torch.cat([s_side, engine.pad(s_side, p.shape[0] - scene.shape[0])])[perm]
    with span("icp.setup.seed", dev):
        u = seed_bounds(p, grid, dev)
    with span("icp.prologue", dev):
        state = dict(p=p, side=s_side, u=u,
                     total=identity_similarity(dt, dev) if init is None else init)
        loop = LoopState(max_iter, max_iter, threshold, False, dev)

    def step():
        p = state["p"]
        _, y, nv, d2 = closest_point_indices_grid(p, grid, state["u"], scene_tile=tn,
                                                  max_candidates=max_candidates)
        y = y.to(dt)
        w_eff = grid_weights(p, y, d2, w, trim_fraction)
        sim, p_new, err = engine.step(p, y, nv.to(dt), state["side"], w_eff)
        _advance(engine, loop, state, sim, p_new, err, u=next_bound(y, p_new))

    loop.run(step)
    with span("icp.finish", dev):
        return loop.finish(state["p"][inv_slots], state["total"], dt, trace)


def run_plane(engine: PlaneEngine, cfg, model, normals, scene, s_side=None, *,
              init: Optional[Similarity] = None, trace: bool = False, scene_n=None,
              model_n=None):
    """The dense or the grid loop of a plane engine, as ``cfg`` resolves
    the NN method on the clouds' true counts (``scene_n``/``model_n``)."""
    n_points = max(true_count(model.shape[0], model_n), true_count(scene.shape[0], scene_n))
    nn_method = cfg.resolved_nn_method(model.device.type, n_points)
    kw = dict(threshold=cfg.threshold, max_iter=cfg.max_iter, init=init, trace=trace,
              trim_fraction=cfg.trim_fraction, scene_n=scene_n, model_n=model_n)
    if nn_method == "grid":
        return grid_loop(engine, model, normals, scene, s_side,
                         scene_tile_target=cfg.grid_scene_tile,
                         model_tile_target=cfg.grid_model_tile,
                         max_candidates=cfg.grid_max_candidates, **kw)
    return dense_loop(engine, model, normals, scene, s_side, nn_method=nn_method, **kw)


def run_engine(engine: str, model, scene, config=None, *, model_normals=None,
               scene_normals=None, **kw):
    """Register with the engine of the CLI's ``--engine`` name; the normals,
    when given, go to the engines that take them (``scene_normals``: the
    symmetric and GICP engines).  ``kw``: the engine's other keywords
    (``trace``, ``init``, ``scene_n``, ``model_n``, ``device``...)."""
    if engine == "point_to_point":
        from icp_tpu_torch.engine.icp import icp

        return icp(model, scene, config, **kw)
    if engine == "point_to_plane":
        from icp_tpu_torch.engine.point_to_plane import icp_point_to_plane

        return icp_point_to_plane(model, scene, config, normals=model_normals, **kw)
    if engine == "symmetric":
        from icp_tpu_torch.engine.symmetric import icp_symmetric

        return icp_symmetric(model, scene, config, normals=model_normals,
                             scene_normals=scene_normals, **kw)
    if engine == "gicp":
        from icp_tpu_torch.engine.gicp import icp_generalized

        return icp_generalized(model, scene, config, model_normals=model_normals,
                               scene_normals=scene_normals, **kw)
    raise ValueError(f"unknown engine {engine!r}; one of {', '.join(ENGINES)}")
