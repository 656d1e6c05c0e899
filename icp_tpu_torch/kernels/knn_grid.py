"""K7: kd-tile work-list exact k nearest neighbours (``csrc/knn_grid.cu``)
and its torch-side two-phase search.

Port of ``icp_tpu/kernels/knn_grid.py``.  kNN has no previous iteration to
bound it, so ``knn_grid`` runs the kernel twice, as the JAX function does:

  1. seed: each query tile folds its ``c0 = min(nj, max(2, ceil(k/tm)+1))``
     nearest model tiles by box distance (a stable sort); the k-th distance
     of each point is an upper bound on its true k-th NN distance;
  2. cull + exact pass: ``u = d_seed[:, k-1] * _UPPER_INFLATE``, the
     per-tile maximum, and a model tile stays when its box distance is at
     most that (no second inflation); the raw counts go to the kernel, so
     a tile whose count passes the table's capacity folds every tile.  The
     exact pass takes ``d_seed[:, k-1]`` itself as each point's bound: the
     seed's k points are in the culled tiles, so every true neighbour is
     within it, and rows beyond it are no candidates.

The result equals ``knn_dense(query, grid.model_orig, k)`` in every case:
(N, k) squared distances and ORIGINAL model indices, ascending by
(distance, index).  The kernel cuts each query tile's fold list into work
items of a few model tiles (``knn_work_items``); ``knn_worklist_plain`` is
K7's plain version, which the wrapper takes only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from icp_tpu_torch.kernels import _build
from icp_tpu_torch.kernels.knn_dense import check_k
from icp_tpu_torch.kernels.nn_grid import (
    _UPPER_INFLATE,
    ModelGrid,
    _round_up,
    check_table,
    folded_pairs,
    tile_box_dists,
    tile_ids,
)
from icp_tpu_torch.utils.profiling import count_later, host_wait

_INT_MAX = 2 ** 31 - 1
TILES_PER_ITEM = 8  # model tiles a work item of a candidate list
MAX_SPLIT = 64  # a list of every tile is cut into at most this many items


def item_tiles(nj: int):
    """(model tiles an item of a candidate list, of a list of all ``nj``
    tiles): the second keeps a straggler's items (and its merge) few."""
    return TILES_PER_ITEM, max(TILES_PER_ITEM, -(-nj // MAX_SPLIT))


def knn_work_items(counts: torch.Tensor, cap: int, nj: int):
    """K7's plan, as its plan kernel computes it: (first (Ni + 1,) int32,
    slots (Ni + 1,) int32).  ``first``: each query tile's first work item
    and, last, the total; an item is up to ``item_tiles(nj)`` consecutive
    tiles of the tile's fold list (``tile_ids``).  ``slots``: each tile's
    first scratch slot (one per item, for tiles of more than one item,
    whose partial lists the merge pass combines) and, last, the total."""
    g, gf = item_tiles(nj)
    c = counts.long()
    over = c > cap
    length = torch.where(over, torch.full_like(c, nj), c.clamp(min=1))
    items = -(-length // torch.where(over, torch.full_like(c, gf), torch.full_like(c, g)))
    multi = torch.where(items > 1, items, torch.zeros_like(items))
    zero = torch.zeros(1, dtype=torch.int64, device=counts.device)
    return (torch.cat([zero, items.cumsum(0)]).to(torch.int32),
            torch.cat([zero, multi.cumsum(0)]).to(torch.int32))


def _check_bound(bound: torch.Tensor | None, query: torch.Tensor) -> None:
    if bound is not None and (bound.shape != (query.shape[0],) or bound.dtype != torch.float32
                              or bound.device != query.device or not bound.is_contiguous()):
        raise ValueError("knn_grid: bound must be a contiguous float32 (N,) tensor "
                         "beside the query")


def knn_worklist(cand: torch.Tensor, counts: torch.Tensor, query: torch.Tensor,
                 tiles: torch.Tensor, scene_tile: int, k: int,
                 bound: torch.Tensor | None = None):
    """K7: (d2 (N, k) float32, idx (N, k) int32) for the tile-padded query
    (Ni * scene_tile rows) over each tile's candidate model tiles.

    ``bound``: optional (N,) upper bounds on each query's k-th distance over
    its fold list; only rows within it are candidates, so the result is
    the same with or without it.  A query with fewer than k rows within its
    bound (a bound that breaks that promise) gets d2 = +inf, index -1 in
    the missing places."""
    check_table("knn_grid", cand, counts, query, tiles, scene_tile)
    _check_bound(bound, query)
    check_k("knn_grid", k, k)
    count_later(_k7_counters, counts, cand.shape[1], tiles.shape[0], tiles.shape[1], scene_tile)
    dev = query.device
    if dev.type == "cpu":
        return knn_worklist_plain(cand, counts, query, tiles, scene_tile, k, bound)
    ni, cap = cand.shape
    nj, tm = tiles.shape[0], tiles.shape[1]
    n = query.shape[0]
    g, gf = item_tiles(nj)
    lib, stream = _build.lib(), _build.stream_ptr(query)
    d2 = torch.empty((n, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    plan = torch.empty(2 * ni + 3, dtype=torch.int32, device=dev)
    totals = (ctypes.c_int * 2)()  # the plan's items and scratch slots, read back
    with host_wait():
        _build.check(lib.knn_grid_plan(counts.data_ptr(), ni, cap, nj, g, gf, plan.data_ptr(),
                                       ctypes.addressof(totals), stream), "knn_grid")
    items, slots = totals
    # partial k-lists of the items of tiles with more than one item
    scratch = torch.empty(slots * scene_tile * k, dtype=torch.int64, device=dev) if slots else None
    code = lib.knn_grid_launch(
        cand.data_ptr(), counts.data_ptr(), ni, cap, g, gf, query.data_ptr(),
        None if bound is None else bound.data_ptr(), scene_tile, nj, tm, tiles.data_ptr(), k,
        plan.data_ptr(), items, None if scratch is None else scratch.data_ptr(),
        d2.data_ptr(), idx.data_ptr(), stream)
    _build.LAUNCHES["knn_grid"] += 1
    _build.check(code, "knn_grid")
    return d2, idx


def _k7_counters(counts, cap: int, nj: int, tm: int, tn: int) -> dict:
    """K7's tracing counters of one launch (``utils/profiling.py``)."""
    return {"k7_rows": counts.shape[0] * tn, "k7_pairs": folded_pairs(counts, cap, nj, tm, tn)}


def knn_worklist_plain(cand, counts, query, tiles, scene_tile, k, bound=None):
    """Plain version of K7: per query tile, the k lexicographically least
    (diff-squares distance, original index) pairs over its candidate tiles
    (a stable sort by index, then a stable sort by distance), among the
    rows within ``bound`` when one is given."""
    _check_bound(bound, query)
    nj = tiles.shape[0]
    dev = query.device
    n = query.shape[0]
    d2 = torch.empty((n, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    for ti, cnt in enumerate(counts.tolist()):
        rows = tiles[tile_ids(cand, nj, ti, cnt)].reshape(-1, 4)
        rows = rows[torch.argsort(rows[:, 3], stable=True)]
        lo = ti * scene_tile
        q = query[lo:lo + scene_tile]
        dx = q[:, None, 0] - rows[None, :, 0]
        dy = q[:, None, 1] - rows[None, :, 1]
        dz = q[:, None, 2] - rows[None, :, 2]
        d = (dx * dx + dy * dy) + dz * dz
        if bound is not None:  # rows beyond the bound sort last, as NaN
            d = torch.where(d <= bound[lo:lo + scene_tile, None], d, float("nan"))
        vals, order = torch.sort(d, dim=1, stable=True)  # tiles hold >= 128 rows > k
        vals, oidx = vals[:, :k], rows[order[:, :k], 3]
        # padding rows (index 3e38) as the kernel writes them: INT_MAX;
        # places past the rows within the bound: +inf and -1
        missing = torch.isnan(vals)
        d2[lo:lo + scene_tile] = torch.where(missing, float("inf"), vals)
        oi = torch.where(oidx < 16777216.0, oidx.to(torch.int64),
                         torch.full_like(oidx, _INT_MAX, dtype=torch.int64))
        idx[lo:lo + scene_tile] = torch.where(missing, -1, oi).to(torch.int32)
    return d2, idx


def seed_table(bd2: torch.Tensor, k: int, tm: int):
    """The seed launch's table: each query tile's ``c0`` nearest model
    tiles by box distance (a stable sort), ``c0 = min(nj, max(2,
    ceil(k / tm) + 1))``; (cand (Ni, c0) int32, counts (Ni,) int32)."""
    ni, nj = bd2.shape
    c0 = min(nj, max(2, -(-k // tm) + 1))
    order = torch.argsort(bd2, dim=1, stable=True)[:, :c0].to(torch.int32).contiguous()
    return order, torch.full((ni,), c0, dtype=torch.int32, device=bd2.device)


def cull_table(bd2: torch.Tensor, kth_d2: torch.Tensor, scene_tile: int, cap: int):
    """The exact pass's table: a model tile stays when its box distance is at
    most the query tile's largest inflated seed bound (no second
    inflation); (cand (Ni, cap) int32 ascending, 0 past the count; RAW
    counts (Ni,) int32, so a tile past ``cap`` folds every tile)."""
    ni, nj = bd2.shape
    u_tile = (kth_d2 * _UPPER_INFLATE).reshape(ni, scene_tile).amax(1)
    mask = bd2 <= u_tile[:, None]
    counts = mask.sum(1).to(torch.int32)
    col = torch.arange(nj, dtype=torch.int32, device=bd2.device)
    keys = torch.where(mask, col[None, :], torch.full_like(col, nj)[None, :])
    del mask
    keys = torch.sort(keys, dim=1).values[:, :cap]
    cand = torch.where(keys < nj, keys, torch.zeros_like(keys)).contiguous()
    return cand, counts


def knn_grid(query: torch.Tensor, grid: ModelGrid, k: int, *,
             scene_tile: int = 256, max_candidates: int = 16):
    """Exact k nearest model points per query row, with tile culling:
    (d2 (N, k) float32, idx (N, k) int32 ORIGINAL indices), ascending by
    (distance, index).  ``query`` should be kd-sorted for the cull to bite;
    the result never depends on it."""
    n = query.shape[0]
    check_k("knn_grid", k, grid.model_orig.shape[0])
    query = query.to(torch.float32)
    tn = min(scene_tile, _round_up(n, 8))
    n_pad = _round_up(n, tn)
    if n_pad > n:  # replicate the last point: tile boxes stay tight
        query = torch.cat([query, query[-1:].expand(n_pad - n, 3)])
    query = query.contiguous()
    # (Ni, Nj) box distances, built one axis at a time; the cull holds at
    # most this and one mask of the same shape
    bd2 = tile_box_dists(query, grid, scene_tile=tn)
    d_seed, _ = knn_worklist(*seed_table(bd2, k, grid.model_tile), query, grid.tiles, tn, k)
    cand, counts = cull_table(bd2, d_seed[:, k - 1], tn, min(max_candidates, bd2.shape[1]))
    del bd2
    d_full, i_full = knn_worklist(cand, counts, query, grid.tiles, tn, k,
                                  bound=d_seed[:, k - 1].contiguous())
    return d_full[:n], i_full[:n]
