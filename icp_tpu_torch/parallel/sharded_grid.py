"""Sharded grid-pruned ICP: the ring fold with kd-tile culling on every hop
(port of ``icp_tpu/parallel/sharded_grid.py``).

The ring of ``parallel/sharded.py`` with K4 (``kernels/nn_grid.py``) in
place of the dense search:

  * each rank kd-sorts ITS scene rows once and builds a ``ModelGrid`` over
    ITS model rows once; every field of the grid K4 reads (the tiles, their
    boxes, the original-order points, the inverse permutation ``kd_row``
    through which K4's epilogue reads the winner, and the normals payload)
    rides the ring, so a hop always searches one rank's grid as a whole;
  * on each hop the visiting shard's tiles are culled against
    ``min(best_d, u)``: the running cross-hop best tightens the bound hop
    by hop;
  * cross-hop ties break to the lowest GLOBAL original index: K4's
    distances are the diff-squares float32 form on every hop, so the
    equality comparisons are exact;
  * ``u``, each point's squared distance to its previous match, bounds the
    next NN distance from above (the first bounds: K1 against every 16th
    point of the rank's own model shard, which bounds the global nearest
    distance too).

``gn_sharded_grid`` is the plane engines' loop: the model normals ride K4's
payload slot, the scene's side rows are kd-permuted with its points.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from icp_tpu_torch.config import ICPConfig
from icp_tpu_torch.engine.icp import LoopState
from icp_tpu_torch.kernels.nn_grid import (
    _round_up,
    bound_from_indices,
    build_model_grid,
    closest_point_indices_grid,
    initial_bound_indices,
    kd_order,
    levels_for,
    next_bound,
)
from icp_tpu_torch.ops.transform import identity_similarity
from icp_tpu_torch.parallel.sharded import (
    _BIG,
    _INT_MAX,
    _MODEL_PAD,
    Axis,
    _fold,
    check_trace_bound,
    gathered,
    ppermute,
    prepared,
    reducer,
    run_loop,
    shard_rows,
    similarity_step,
    trimmed,
)
from icp_tpu_torch.utils.precision import in_full_float32


def _prepare_scene_shard(p_loc, w_loc, target_tile: int):
    """kd-sort and pad ONE rank's scene rows: (p_sorted, w_sorted,
    inv_slots, tn, perm).  ``w_loc`` marks the globally real rows (the pad
    rows of the global padding sit on the last rank); the kd padding
    repeats the last row with weight 0, and real rows sort before padding
    within their segment.  ``perm`` maps sorted slots to local rows (for
    the scene's side data)."""
    n = p_loc.shape[0]
    lvl = levels_for(n, target_tile)
    tn = _round_up(-(-n // (2 ** lvl)), 8)
    n_pad = tn * (2 ** lvl)
    p_pad = torch.cat([p_loc, p_loc[-1:].expand(n_pad - n, 3)])
    w_pad = torch.cat([w_loc, w_loc.new_zeros(n_pad - n)])
    perm = kd_order(p_pad, lvl, real=w_pad > 0)
    inv_slots = torch.argsort(perm)[:n]
    return p_pad[perm], w_pad[perm], inv_slots, tn, perm


def _grid_fields(grid) -> list:
    """The tensors of a ``ModelGrid`` that ride the ring."""
    fields = [grid.tiles, grid.tile_lo, grid.tile_hi, grid.model_orig, grid.kd_row]
    return fields + ([grid.payload] if grid.payload is not None else [])


def _ring_correspond_grid(p, u, grid, axis: Axis, *, m_shard: int, scene_tile: int,
                          max_candidates: int):
    """Grid-pruned ring fold: (y, global index, float32 distance, winning
    payload rows or None).  ``u``: (N_loc,) float32 upper bounds on the
    global NN distance; ``grid``: this rank's ``ModelGrid``."""
    n = p.shape[0]
    dev = p.device
    width = grid.payload_width
    best = (torch.full((n,), _BIG, dtype=torch.float32, device=dev),
            torch.full((n,), _INT_MAX, dtype=torch.int32, device=dev),
            [torch.zeros((n, 3), dtype=torch.float32, device=dev)]
            + ([torch.zeros((n, width), dtype=torch.float32, device=dev)] if width else []))
    fields = _grid_fields(grid)
    for k in range(axis.size):
        src = (axis.rank - k) % axis.size  # owner of the held grid
        g = grid._replace(tiles=fields[0], tile_lo=fields[1], tile_hi=fields[2],
                          model_orig=fields[3], kd_row=fields[4],
                          payload=fields[5] if width else None)
        # both bounds are distances to real model points: exact upper bounds
        idx, y, pl, d2 = closest_point_indices_grid(p, g, torch.minimum(best[0], u),
                                                    scene_tile=scene_tile,
                                                    max_candidates=max_candidates)
        best = _fold(best, d2, idx + src * m_shard, [y] + ([pl] if width else []))
        if k < axis.size - 1:  # no pass after the last hop
            fields = ppermute(fields, axis)
    best_d, best_gi, rows = best
    return rows[0], best_gi, best_d, rows[1] if width else None


class _GridShard:
    """One rank's part of a sharded grid run: the model shard's grid, the
    kd-sorted scene shard and its weights, and the first bounds."""

    def __init__(self, model, scene, mesh: DeviceMesh, cfg: ICPConfig, payload=None):
        self.axis = Axis(mesh, mesh.mesh_dim_names[0])
        dev = scene.device
        m_loc = shard_rows(model, mesh, _MODEL_PAD)
        self.m_shard = m_loc.shape[0]
        pl = None if payload is None else shard_rows(payload, mesh)
        self.grid = build_model_grid(m_loc, target_tile=cfg.grid_model_tile, payload=pl)
        p_raw = shard_rows(scene, mesh)
        w_raw = shard_rows(torch.ones(scene.shape[0], dtype=cfg.dtype, device=dev), mesh)
        self.p0, self.w, self.inv_slots, self.tn, self.perm = _prepare_scene_shard(
            p_raw, w_raw, cfg.grid_scene_tile)
        self.n_loc = p_raw.shape[0]
        stride = max(1, min(16, self.m_shard // 4))  # the seed's model stride
        self.u0 = bound_from_indices(self.p0, self.grid, initial_bound_indices(
            self.p0, self.grid.model_orig, stride=stride))
        self.max_candidates = cfg.grid_max_candidates

    def correspond(self, p, u):
        return _ring_correspond_grid(p, u, self.grid, self.axis, m_shard=self.m_shard,
                                     scene_tile=self.tn, max_candidates=self.max_candidates)

    def kd_rows(self, side: torch.Tensor) -> torch.Tensor:
        """This rank's scene side rows (N_loc, ...) with zero rows for the kd
        padding, in the kd order of the points."""
        pad = side.new_zeros((self.p0.shape[0] - self.n_loc,) + side.shape[1:])
        return torch.cat([side, pad])[self.perm]


@in_full_float32
def icp_sharded_grid(model, scene, config: Optional[ICPConfig] = None, *,
                     mesh: Optional[DeviceMesh] = None, trace: bool = False, n_iters=None):
    """Spatially pruned ICP over a ``points`` mesh, ``icp_sharded``'s
    contract (``icp_sharded`` with ``nn_method="grid"`` runs it).  The
    model pad rows at 1e17 form far tiles that every cull drops."""
    cfg = config or ICPConfig()
    check_trace_bound(trace, n_iters, cfg.max_iter)
    mesh, dev, model, scene = prepared(model, scene, cfg, mesh)
    dt, n = cfg.dtype, scene.shape[0]
    sh = _GridShard(model, scene, mesh, cfg)
    kw = dict(solver=cfg.resolved_solver(dev.type), with_scale=cfg.with_scale,
              reference_compat=cfg.reference_compat)

    def step(state):
        p = state["p"]
        y, _, d2, _ = sh.correspond(p, state["u"])
        y = y.to(dt)
        w_eff = trimmed(sh.w, d2.to(dt), cfg.trim_fraction, sh.axis.group)
        sim, p_new, err = similarity_step(p, y, w_eff, sh.axis.group, **kw)
        # the next bound: the residual to this iteration's match
        return sim, p_new, err, dict(u=next_bound(y, p_new))

    bound = cfg.max_iter if n_iters is None else int(n_iters)
    # n_iters may exceed max_iter without a trace, as in JAX: the buffer
    # then holds every iteration's error
    loop = LoopState(bound, max(bound, cfg.max_iter), cfg.threshold, cfg.reference_compat, dev)
    state = dict(p=sh.p0, side=None, u=sh.u0, total=identity_similarity(dt, dev))
    return gathered(run_loop(step, state, loop, dt, trace), sh.axis, n, trace, sh.inv_slots)


def gn_sharded_grid(engine, side_of, model, model_normals, scene, scene_normals,
                    cfg: ICPConfig, *, mesh: DeviceMesh, trace: bool = False):
    """The sharded grid loop of a plane engine (``sharded.gn_sharded``
    dispatches here): the model normals ride K4's payload slot and the ring,
    the winning (point, normal) comes out of the fold; ``side_of`` makes
    the scene's side rows (normals, covariances) of its normals, kd-permuted
    with the points (zero normals, so GICP's identity covariance, on the kd
    padding, of weight 0)."""
    dt, n = cfg.dtype, scene.shape[0]
    dev = scene.device
    sh = _GridShard(model, scene, mesh, cfg, payload=model_normals)
    side = None
    if side_of is not None:
        side = side_of(sh.kd_rows(shard_rows(scene_normals, mesh)))
    reduce = reducer(sh.axis.group)

    def step(state):
        p = state["p"]
        y, _, d2, nv = sh.correspond(p, state["u"])
        y = y.to(dt)
        w_eff = trimmed(sh.w, d2.to(dt), cfg.trim_fraction, sh.axis.group)
        sim, p_new, err = engine.step(p, y, engine.rows(nv.to(dt)), state["side"], w_eff,
                                      reduce=reduce)
        return sim, p_new, err, dict(u=next_bound(y, p_new))

    loop = LoopState(cfg.max_iter, cfg.max_iter, cfg.threshold, False, dev)
    state = dict(p=sh.p0, side=side, u=sh.u0, total=identity_similarity(dt, dev))
    return gathered(run_loop(step, state, loop, dt, trace, engine), sh.axis, n, trace,
                    sh.inv_slots)
