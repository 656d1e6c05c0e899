"""ICP over the kd-tile grid NN path (port of ``icp_tpu/engine/grid.py``).

Same loop as ``engine/icp.py`` with three at-scale changes:

  * the scene is kd-sorted once before the loop (a similarity keeps
    neighbourhoods, so its tiles stay compact) and un-permuted at the end;
  * the loop carries ``u``, each point's squared distance to its previous
    match, an upper bound on its next NN distance that lets K4 cull model
    tiles (exact in every case);
  * the cloud is padded to the tile multiple by replicating its last point;
    padded rows have weight 0 in the sums, the trim quantile and the error,
    as are the pad rows of a bucket-padded scene (``scene_n``), which
    ``bucket_prologue`` replica-fills before the kd sort.

The first bounds come from K1 against every 16th model point (every 64th
on the card: ``BOUND_STRIDE_CUDA``).  Each
iteration: K4 (with the candidate table built in torch), the trim weights
from K4's own float32 distances (recomputed from y and p in float64
configurations, as JAX does), the float64 Horn sums in torch, K2 (solve,
compose, convergence test), and the float32 apply of the step in torch.
"""

from __future__ import annotations

from typing import Optional

import torch

from icp_tpu_torch.config import grid_sizes
from icp_tpu_torch.engine.icp import LoopState, bucket_prologue
from icp_tpu_torch.kernels.nn_grid import (
    _round_up,
    bound_from_indices,
    build_model_grid,
    closest_point_indices_grid,
    initial_bound_indices,
    kd_order,
    levels_for,
    next_bound,
    sqnorm_rows,
)
from icp_tpu_torch.kernels.qcp import (
    identity_state,
    pack_stats,
    pack_total_state,
    qcp_step,
    step_similarity,
    unpack_state,
)
from icp_tpu_torch.ops.alignment import (
    Similarity,
    alignment_from_stats,
    compute_alignment_stats,
)
from icp_tpu_torch.ops.quantile import histogram_quantile
from icp_tpu_torch.ops.transform import apply_similarity, compose, identity_similarity
from icp_tpu_torch.utils.profiling import span


# The model stride of the first bounds (K1 against every stride-th model
# point) where the caller gives none: JAX's 16 on the CPU; on the card 64,
# as ``scripts/dispatch_sweep.py --sections grid`` measured it (NVIDIA H100
# 80GB HBM3, 700 W; ``perf_h100/grid_sweep.jsonl``): set-up + first
# iteration of the 1M pair 35.8 -> 17.4 ms (K1's seed a quarter of the
# pairs; the first table folds 6% more), ms an iteration unchanged.
BOUND_STRIDE = 16
BOUND_STRIDE_CUDA = 64


def bound_stride_for(device) -> int:
    """The first bounds' model stride on ``device`` (a ``torch.device``)."""
    return BOUND_STRIDE_CUDA if device.type == "cuda" else BOUND_STRIDE


def seed_bounds(p, grid, device, bound_stride=None):
    """(N,) first bounds of the kd-sorted scene ``p``: the squared distance
    to its nearest of every stride-th model point (K1), the stride the
    caller's or the device's, at most a quarter of the model."""
    stride = bound_stride_for(device) if bound_stride is None else bound_stride
    stride = max(1, min(stride, grid.model_orig.shape[0] // 4))
    return bound_from_indices(p, grid, initial_bound_indices(p, grid.model_orig, stride=stride))


def _prepare_scene(scene: torch.Tensor, target_tile: int, n_valid=None):
    """kd-sort + pad the scene: (p_sorted, weights, inv_slots, tn, perm);
    ``p_sorted[inv_slots]`` restores the caller's order.  ``n_valid``: the
    valid rows of a bucket-padded scene (its pad rows replica-filled
    already); rows past it get weight 0 like the tile padding."""
    n = scene.shape[0]
    lvl = levels_for(n, target_tile)
    tn = _round_up(-(-n // (2 ** lvl)), 8)
    n_pad = tn * (2 ** lvl)
    s_pad = torch.cat([scene, scene[-1:].expand(n_pad - n, 3)])
    perm = kd_order(s_pad, lvl)
    p_sorted = s_pad[perm]
    w = (perm < (n if n_valid is None else n_valid)).to(scene.dtype)
    inv_slots = torch.argsort(perm)[:n]
    return p_sorted, w, inv_slots, tn, perm


def grid_weights(p, y, d2, w, trim_fraction: float):
    """The weights of one grid iteration: the tile and bucket weights ``w``,
    times the trim's on K4's float32 distances ``d2`` (recomputed from y
    and p when the cloud is wider than float32); the quantile leaves out
    the rows of weight 0."""
    if trim_fraction <= 0.0:
        return w
    if p.dtype != torch.float32:
        d2 = sqnorm_rows(y - p)
    tau = histogram_quantile(d2, 1.0 - trim_fraction, w)
    return w * (d2 <= tau).to(w.dtype)


def _icp_grid(model, scene, *, threshold: float, bound: int, length: int,
              solver: str, with_scale: bool, reference_compat: bool,
              scene_tile_target: int | None = None, model_tile_target: int | None = None,
              max_candidates: int | None = None, bound_stride: int | None = None,
              init: Optional[Similarity] = None, trace: bool = False,
              converge: bool = True, trim_fraction: float = 0.0, scene_n=None,
              model_n=None):
    dt, dev = scene.dtype, scene.device
    with span("icp.prologue", dev):
        scene_tile_target, model_tile_target, max_candidates = grid_sizes(
            dev, scene_tile_target, model_tile_target, max_candidates)
        model, scene, _ = bucket_prologue(model, scene, scene_n, model_n)
        if init is not None:
            scene = apply_similarity(scene, init)
    with span("icp.setup.model_grid", dev):
        grid = build_model_grid(model, target_tile=model_tile_target)
    with span("icp.setup.scene_sort", dev):
        p, w, inv_slots, tn, _ = _prepare_scene(scene, scene_tile_target, n_valid=scene_n)
    with span("icp.setup.seed", dev):
        u = seed_bounds(p, grid, dev, bound_stride)
    with span("icp.prologue", dev):
        loop = LoopState(bound, length, threshold, reference_compat, dev, converge)
        if solver == "qcp_fused":
            state = identity_state(dev) if init is None else pack_total_state(init, dev)
        else:
            total = identity_similarity(dt, dev) if init is None else init

    if solver == "qcp_fused":
        def step():
            nonlocal p, u
            _, y, _, d2 = closest_point_indices_grid(p, grid, u, scene_tile=tn,
                                                     max_candidates=max_candidates)
            y = y.to(dt)
            w_eff = grid_weights(p, y, d2, w, trim_fraction)
            stats = compute_alignment_stats(p, y, acc_dtype=torch.float64, weights=w_eff)
            qcp_step(pack_stats(stats), state, loop.ctl, loop.errs,
                     **loop.step_kw(with_scale))
            p = apply_similarity(p, step_similarity(state, dt))
            u = next_bound(y, p)
    else:
        def step():
            nonlocal p, u, total
            if loop.done():
                return
            _, y, _, d2 = closest_point_indices_grid(p, grid, u, scene_tile=tn,
                                                     max_candidates=max_candidates)
            y = y.to(dt)
            w_eff = grid_weights(p, y, d2, w, trim_fraction)
            stats = compute_alignment_stats(p, y, weights=w_eff)
            sim = alignment_from_stats(stats, solver=solver, with_scale=with_scale)
            p = apply_similarity(p, sim)
            total = compose(total, sim)
            d = y - p
            loop.record((w_eff * (d * d).sum(1)).sum(), stats.n)
            u = next_bound(y, p)

    loop.run(step)
    with span("icp.finish", dev):
        if solver == "qcp_fused":
            total = Similarity(*(v.to(dt) for v in unpack_state(state)[1]))
        return loop.finish(p[inv_slots], total, dt, trace)
