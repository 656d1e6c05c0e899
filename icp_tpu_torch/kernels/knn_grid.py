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
     a tile whose count passes the table's capacity folds every tile.

The result equals ``knn_dense(query, grid.model_orig, k)`` in every case:
(N, k) squared distances and ORIGINAL model indices, ascending by
(distance, index).  ``knn_worklist_plain`` is K7's plain version; the
wrapper takes it only for CPU tensors.
"""

from __future__ import annotations

import torch

from icp_tpu_torch.kernels import _build
from icp_tpu_torch.kernels.knn_dense import check_k
from icp_tpu_torch.kernels.nn_grid import (
    _UPPER_INFLATE,
    ModelGrid,
    _round_up,
    check_table,
    tile_box_dists,
    tile_ids,
)

_INT_MAX = 2 ** 31 - 1


def knn_worklist(cand: torch.Tensor, counts: torch.Tensor, query: torch.Tensor,
                 tiles: torch.Tensor, scene_tile: int, k: int):
    """K7: (d2 (N, k) float32, idx (N, k) int32) for the tile-padded query
    (Ni * scene_tile rows) over each tile's candidate model tiles."""
    check_table("knn_grid", cand, counts, query, tiles, scene_tile)
    if not 1 <= k <= 32:
        raise ValueError(f"knn_grid: k={k} outside 1..32")
    dev = query.device
    if dev.type == "cpu":
        return knn_worklist_plain(cand, counts, query, tiles, scene_tile, k)
    ni, cap = cand.shape
    nj, tm = tiles.shape[0], tiles.shape[1]
    n = query.shape[0]
    d2 = torch.empty((n, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    code = _build.lib().knn_grid_launch(
        cand.data_ptr(), counts.data_ptr(), ni, cap, query.data_ptr(),
        scene_tile, nj, tm, tiles.data_ptr(), k, d2.data_ptr(), idx.data_ptr(),
        _build.stream_ptr(query))
    _build.LAUNCHES["knn_grid"] += 1
    _build.check(code, "knn_grid")
    return d2, idx


def knn_worklist_plain(cand, counts, query, tiles, scene_tile, k):
    """Plain version of K7: per query tile, the k lexicographically least
    (diff-squares distance, original index) pairs over its candidate tiles
    (a stable sort by index, then a stable sort by distance)."""
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
        vals, order = torch.sort(d, dim=1, stable=True)  # tiles hold >= 128 rows > k
        oidx = rows[order[:, :k], 3]
        d2[lo:lo + scene_tile] = vals[:, :k]
        # padding rows (index 3e38) as the kernel writes them: INT_MAX
        idx[lo:lo + scene_tile] = torch.where(
            oidx < 16777216.0, oidx.to(torch.int64),
            torch.full_like(oidx, _INT_MAX, dtype=torch.int64)).to(torch.int32)
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
    d_full, i_full = knn_worklist(cand, counts, query, grid.tiles, tn, k)
    return d_full[:n], i_full[:n]
