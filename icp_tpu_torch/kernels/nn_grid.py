"""K4: kd-tile work-list nearest neighbour (``csrc/nn_grid.cu``) and the
torch side of the grid path.

Port of ``icp_tpu/kernels/nn_grid.py``: the model is kd-sorted once into
2^L equal tiles with bounding boxes; the scene is kd-sorted once by the
engine; each iteration, scene tile i keeps model tile j as a candidate when
the squared box-box distance is at most the tile's largest upper bound on
its points' nearest-neighbour distances (the previous match's distance).
The kernel folds each scene tile's candidates, or all tiles when their
count passes the table's capacity, as work items of one model tile each
(``work_item_offsets``) that merge by the lexicographic minimum of
(squared distance, original model index): the result is exact in every
case.  Each scene tile's ``NEAR_TILES`` fold-list tiles nearest its box
(``near_tiles``) are folded first, in a pass of their own; the main pass
then skips any item whose model tile's box lies farther from every point
than the point's best so far, which can neither win nor tie, so the
answer is unchanged.  The winner's point and payload row are read through
the grid's inverse permutation (``ModelGrid.kd_row``); a grid built with a
payload (the plane engines' normals) also gives the winner's payload row.

The torch side mirrors the JAX functions so the two build the same
permutations, tiles and candidate tables: ``kd_order`` sorts with
``torch.argsort(stable=True)`` as ``jnp.argsort`` is stable.
``nn_grid_plain`` is K4's plain version; the wrapper takes it only for CPU
tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from icp_tpu_torch.kernels import _build
from icp_tpu_torch.kernels.nn_dense import check_points, closest_point_indices_dense
from icp_tpu_torch.utils.profiling import count_later, host_wait

_BIG = 3.0e38
_PAD_COORD = 1.0e17
# float32 safety margins: u must stay an upper bound and the box distance a
# lower bound through float32 rounding, or a winning tile could be culled.
_UPPER_INFLATE = 1.0 + 1e-5
_LOWER_DEFLATE = 1.0 - 1e-5  # csrc/nn_grid.cu's kLowerDeflate too
# Model tiles a scene tile folds in K4's near pass, before any other item:
# those of its fold list whose boxes lie nearest its own.
NEAR_TILES = 2


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def kd_order(points: torch.Tensor, levels: int,
             real: torch.Tensor | None = None) -> torch.Tensor:
    """Permutation grouping ``points`` (n, 3) into 2^levels equal segments by
    recursive widest-axis median split; ``real=False`` rows (padding) sort
    to the tail of their segment and do not count for the axis choice."""
    n = points.shape[0]
    if n % (2 ** levels):
        raise ValueError(f"kd_order: {n} points do not split into 2^{levels}")
    pts = points.to(torch.float32)
    dev = pts.device
    perm = torch.arange(n, dtype=torch.int64, device=dev)
    msk = torch.ones(n, dtype=torch.bool, device=dev) if real is None else real
    with host_wait():  # a copy from the host waits for the stream
        big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    for lvl in range(levels):
        s = 2 ** lvl
        seg = n // s
        p3 = pts.reshape(s, seg, 3)
        m3 = msk.reshape(s, seg)
        ext = (torch.where(m3[..., None], p3, -big).amax(1)
               - torch.where(m3[..., None], p3, big).amin(1))
        ax = torch.argmax(ext, dim=1)  # first of equal extents, as jnp.argmax
        keys = torch.gather(p3, 2, ax[:, None, None].expand(s, seg, 1))[..., 0]
        keys = torch.where(m3, keys, big)  # padding sorts last
        order = torch.argsort(keys, dim=1, stable=True)
        pts = torch.gather(p3, 1, order[..., None].expand(s, seg, 3)).reshape(n, 3)
        msk = torch.gather(m3, 1, order).reshape(n)
        perm = torch.gather(perm.reshape(s, seg), 1, order).reshape(n)
    return perm


def levels_for(n: int, target_tile: int) -> int:
    """Split depth giving ~target_tile points per kd tile."""
    if n <= target_tile:
        return 0
    return max(0, round(math.log2(n / target_tile)))


class ModelGrid(NamedTuple):
    """kd-sorted model + per-tile bounding boxes (built once per run)."""

    tiles: torch.Tensor  # (Nj, tm, 4) float32 rows (x, y, z, original index);
    #                      padding rows at 1e17 with index 3e38
    tile_lo: torch.Tensor  # (Nj, 3) per-tile box minima (real rows only)
    tile_hi: torch.Tensor  # (Nj, 3)
    model_orig: torch.Tensor  # (M, 3) float32 model in its original order
    kd_row: torch.Tensor  # (M,) int32 kd row (tile * tm + row) of each original
    #                       index: the inverse of the kd permutation
    model_tile: int
    payload: torch.Tensor | None = None  # (Nj, tm, 4) float32 per-point values
    #                                      in kd order (padding rows and unused
    #                                      columns 0), or None
    payload_width: int = 0  # the payload's real columns (<= 4)


def build_model_grid(model: torch.Tensor, *, target_tile: int = 1024,
                     payload: torch.Tensor | None = None) -> ModelGrid:
    """kd-sort the model and precompute per-tile bounding boxes.

    ``payload``: optional (M, k) per-point values, k <= 4 (the normals of
    the point-to-plane engine), kept in float32 in kd order beside the
    tiles; the NN kernel then gives the winner's payload row."""
    m = model.shape[0]
    if m >= 2 ** 24:
        raise ValueError(f"grid NN encodes original indices as float32 (exact "
                         f"below 2**24); model has {m} points")
    dev = model.device
    model = model.to(torch.float32).contiguous()
    lvl = levels_for(m, target_tile)
    n_tiles = 2 ** lvl
    tm = _round_up(-(-m // n_tiles), 128)
    m_pad = tm * n_tiles
    pts_p = torch.full((m_pad, 3), _PAD_COORD, dtype=torch.float32, device=dev)
    pts_p[:m] = model
    real0 = torch.arange(m_pad, device=dev) < m
    perm = kd_order(pts_p, lvl, real=real0)
    sorted_pts = pts_p[perm]
    real = perm < m
    kd_row = torch.empty(m_pad, dtype=torch.int32, device=dev)
    kd_row[perm] = torch.arange(m_pad, dtype=torch.int32, device=dev)
    with host_wait():  # a copy from the host waits for the stream
        oidx = torch.where(real, perm.to(torch.float32),
                           torch.tensor(_BIG, dtype=torch.float32, device=dev))
    tiles = torch.cat([sorted_pts, oidx[:, None]], dim=1).reshape(n_tiles, tm, 4)
    tiled = sorted_pts.reshape(n_tiles, tm, 3)
    r3 = real.reshape(n_tiles, tm, 1)
    with host_wait():
        big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    pl_tiles, width = None, 0
    if payload is not None:
        width = payload.shape[1]
        if payload.ndim != 2 or payload.shape[0] != m or not 1 <= width <= 4:
            raise ValueError(f"build_model_grid: payload must be (M, k<=4), got "
                             f"{tuple(payload.shape)} for {m} points")
        pl_pad = torch.zeros((m_pad, 4), dtype=torch.float32, device=dev)
        pl_pad[:m, :width] = payload.to(device=dev, dtype=torch.float32)
        pl_tiles = pl_pad[perm].reshape(n_tiles, tm, 4).contiguous()
    return ModelGrid(
        tiles=tiles.contiguous(),
        tile_lo=torch.where(r3, tiled, big).amin(1),
        tile_hi=torch.where(r3, tiled, -big).amax(1),
        model_orig=model,
        kd_row=kd_row[:m].contiguous(),
        model_tile=tm,
        payload=pl_tiles,
        payload_width=width,
    )


def initial_bound_indices(scene: torch.Tensor, model: torch.Tensor, *,
                          stride: int = 16) -> torch.Tensor:
    """First-iteration upper-bound indices: exact NN (K1) against every
    ``stride``-th model point.  Returns ORIGINAL model indices."""
    sub = model[::stride]
    return closest_point_indices_dense(scene, sub).to(torch.int64) * stride


def sqnorm_rows(d: torch.Tensor) -> torch.Tensor:
    """Row-wise squared norms of (N, 3) in K4's order: (x*x + y*y) + z*z."""
    return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]


def bound_from_indices(scene: torch.Tensor, grid: ModelGrid,
                       idx: torch.Tensor) -> torch.Tensor:
    """(N,) upper bounds on the NN distance: squared distance to a known
    model point (one row gather, before the loop)."""
    return sqnorm_rows(scene.to(torch.float32) - grid.model_orig[idx])


def next_bound(y: torch.Tensor, p_new: torch.Tensor) -> torch.Tensor:
    """(N,) float32 bounds for the next iteration: squared distance from the
    moved point to this iteration's match, from the float32-cast pair (see
    ``icp_tpu/kernels/nn_grid.py:next_bound``)."""
    return sqnorm_rows(y.to(torch.float32) - p_new.to(torch.float32))


def tile_box_dists(p_pad: torch.Tensor, grid: ModelGrid, *,
                   scene_tile: int) -> torch.Tensor:
    """(Ni, Nj) deflated squared box-box distances (a lower bound on any
    point-pair distance between the tiles, through float32 rounding).

    One axis at a time, summed as ``(g0 + g1) + g2``: no (Ni, Nj, 3)
    temporary (0.8 GB at a million points in 64-point tiles)."""
    ni = p_pad.shape[0] // scene_tile
    tiles = p_pad[:, :3].reshape(ni, scene_tile, 3)
    s_lo = tiles.amin(1)
    s_hi = tiles.amax(1)
    acc = None
    for ax in range(3):
        gap = torch.maximum(grid.tile_lo[None, :, ax] - s_hi[:, None, ax],
                            s_lo[:, None, ax] - grid.tile_hi[None, :, ax])
        gap = gap.clamp_(min=0.0)
        gap = gap.mul_(gap)
        acc = gap if acc is None else acc.add_(gap)
    return acc.mul_(_LOWER_DEFLATE)


def candidates(p_pad: torch.Tensor, u_pad: torch.Tensor, grid: ModelGrid, *,
               scene_tile: int, cap: int):
    """Per-scene-tile candidate model tiles: (Ni, C) int32 ids ascending,
    0 past the count; (Ni,) int32 counts; overflow flag (a 0-d tensor)."""
    ni = p_pad.shape[0] // scene_tile
    nj = grid.tile_lo.shape[0]
    u_tile = u_pad.reshape(ni, scene_tile).amax(1) * _UPPER_INFLATE
    mask = tile_box_dists(p_pad, grid, scene_tile=scene_tile) <= u_tile[:, None]
    counts = mask.sum(1).to(torch.int32)
    col = torch.arange(nj, dtype=torch.int32, device=p_pad.device)
    keys = torch.where(mask, col[None, :], torch.full_like(col, nj)[None, :])
    keys = torch.sort(keys, dim=1).values[:, :cap]
    cand = torch.where(keys < nj, keys, torch.zeros_like(keys))
    return cand.contiguous(), counts, (counts > cap).any()


def near_tiles(p_pad: torch.Tensor, grid: ModelGrid, cand: torch.Tensor,
               counts: torch.Tensor, *, scene_tile: int) -> torch.Tensor:
    """(Ni, F) int32, F = min(``NEAR_TILES``, Nj): each scene tile's model
    tiles of least box distance (``tile_box_dists``'), ties broken by the
    squared distance between the boxes' centres, then by the lower tile,
    nearest first; -1 where one is neither a candidate of the table nor
    in a tile past its capacity, so that each is in its fold list
    (``tile_ids``).  On the card one warp a scene tile
    (``nn_grid_near_kernel``), the kernel ``nn_grid`` launches before its
    near pass; ``near_tiles_plain`` is its plain version."""
    if p_pad.device.type == "cpu":
        return near_tiles_plain(p_pad, grid, cand, counts, scene_tile=scene_tile)
    if p_pad.dtype != torch.float32 or not p_pad.is_contiguous():
        raise ValueError("near_tiles: the scene must be a contiguous float32 (N, 3) tensor")
    ni, cap = cand.shape
    nj = grid.tile_lo.shape[0]
    f = min(NEAR_TILES, nj)
    near = torch.empty((ni, f), dtype=torch.int32, device=p_pad.device)
    code = _build.lib().nn_grid_near_launch(
        p_pad.data_ptr(), scene_tile, ni, grid.tile_lo.data_ptr(), grid.tile_hi.data_ptr(), nj,
        cand.data_ptr(), counts.data_ptr(), cap, f, near.data_ptr(), _build.stream_ptr(p_pad))
    _build.LAUNCHES["nn_grid_near"] += 1
    _build.check(code, "nn_grid_near")
    return near


def near_tiles_plain(p_pad, grid, cand, counts, *, scene_tile):
    """Plain version of ``near_tiles``: a stable sort of each scene tile's
    (box distance, centre distance) keys over the (Ni, Nj) matrices."""
    dists = tile_box_dists(p_pad, grid, scene_tile=scene_tile)
    ni, nj = dists.shape
    cap = cand.shape[1]
    tiles = p_pad[:, :3].reshape(ni, scene_tile, 3)
    s_mid = (tiles.amin(1) + tiles.amax(1)) * 0.5
    t_mid = (grid.tile_lo + grid.tile_hi) * 0.5
    acc = None
    for ax in range(3):
        gap = s_mid[:, None, ax] - t_mid[None, :, ax]
        gap = gap.mul_(gap)
        acc = gap if acc is None else acc.add_(gap)
    # both are >= 0, so their float bits order as integers: one int64 key
    # orders by box distance, then by centre distance
    low = acc.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = (dists.view(torch.int32).to(torch.int64) << 32) | low
    near = torch.sort(key, dim=1, stable=True).indices[:, :min(NEAR_TILES, nj)]
    live = torch.arange(cap, device=cand.device)[None, :] < counts[:, None].long()
    is_cand = ((cand.long()[:, :, None] == near[:, None, :]) & live[:, :, None]).any(1)
    listed = is_cand | (counts > cap)[:, None]
    return torch.where(listed, near, -1).to(torch.int32).contiguous()


def check_table(fn: str, cand: torch.Tensor, counts: torch.Tensor,
                query: torch.Tensor, tiles: torch.Tensor, scene_tile: int) -> None:
    """Raise unless the candidate table and the tiles fit the query."""
    check_points(fn, "query", query)
    dev = query.device
    ni, cap = cand.shape
    if cand.dtype != torch.int32 or counts.dtype != torch.int32 \
            or cand.device != dev or counts.device != dev \
            or not cand.is_contiguous() or counts.shape != (ni,):
        raise ValueError(f"{fn}: cand (Ni, C) and counts (Ni,) must be "
                         "contiguous int32 tensors beside the query")
    if tiles.ndim != 3 or tiles.shape[2] != 4 or tiles.dtype != torch.float32 \
            or tiles.device != dev or not tiles.is_contiguous():
        raise ValueError(f"{fn}: tiles must be a contiguous float32 "
                         "(Nj, tm, 4) tensor beside the query")
    if query.shape[0] != ni * scene_tile or cap < 1:
        raise ValueError(f"{fn}: query has {query.shape[0]} rows, expected "
                         f"{ni} tiles of {scene_tile}")
    if dev.type == "cuda" and scene_tile > 1024:
        raise ValueError(f"{fn}: query tiles hold at most 1024 points on the card")


def nn_grid(cand: torch.Tensor, counts: torch.Tensor, scene: torch.Tensor, grid: ModelGrid,
            scene_tile: int, payload: torch.Tensor | None = None):
    """K4: (d2 (N,) float32, idx (N,) int32, y (N, 3) float32, payload rows
    (N, 4) float32 or None) for the kd-sorted, tile-padded scene
    (Ni * scene_tile rows) against ``grid``'s tiles; ``payload`` is the
    grid's (Nj, tm, 4) or None.  The winner's point and payload row are
    read through the grid's inverse permutation (``kd_row``); the near
    tiles (``near_tiles``) and the grid's boxes, against which an item is
    skipped, change only the work."""
    tiles, kd_row = grid.tiles, grid.kd_row
    check_table("nn_grid", cand, counts, scene, tiles, scene_tile)
    if payload is not None and (payload.shape != tiles.shape or payload.dtype != torch.float32
                                or payload.device != scene.device
                                or not payload.is_contiguous()):
        raise ValueError("nn_grid: payload must be a contiguous float32 tensor "
                         "shaped as the tiles")
    dev = scene.device
    if kd_row.dtype != torch.int32 or kd_row.device != dev or kd_row.ndim != 1 \
            or not kd_row.is_contiguous():
        raise ValueError("nn_grid: kd_row must be a contiguous int32 (M,) tensor "
                         "beside the scene")
    ni, cap = cand.shape
    nj, tm = tiles.shape[0], tiles.shape[1]
    for box in (grid.tile_lo, grid.tile_hi):
        if box.shape != (nj, 3) or box.dtype != torch.float32 or box.device != dev \
                or not box.is_contiguous():
            raise ValueError("nn_grid: the grid's tile_lo and tile_hi must be contiguous "
                             "float32 (Nj, 3) tensors beside the scene")
    if dev.type == "cpu":
        count_later(_k4_counters, counts, cap, nj, tm, scene_tile)
        return nn_grid_plain(cand, counts, scene, tiles, scene_tile, payload, kd_row=kd_row)
    n = scene.shape[0]
    nf = min(NEAR_TILES, nj)
    d2 = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    y = torch.empty((n, 3), dtype=torch.float32, device=dev)
    pl = None if payload is None else torch.empty((n, 4), dtype=torch.float32, device=dev)
    # work items, the two passes' counters, the skipped items, the near tiles
    scratch = torch.empty(ni + 4 + ni * nf, dtype=torch.int32, device=dev)
    keys = torch.empty(n, dtype=torch.int64, device=dev)  # packed (d2, index) minima
    code = _build.lib().nn_grid_launch(
        cand.data_ptr(), counts.data_ptr(), ni, cap, nf, scene.data_ptr(), scene_tile, nj, tm,
        tiles.data_ptr(), grid.tile_lo.data_ptr(), grid.tile_hi.data_ptr(), kd_row.data_ptr(),
        None if payload is None else payload.data_ptr(), scratch.data_ptr(),
        keys.data_ptr(), d2.data_ptr(), idx.data_ptr(), y.data_ptr(),
        None if pl is None else pl.data_ptr(), _build.stream_ptr(scene))
    _build.LAUNCHES["nn_grid"] += 1
    _build.LAUNCHES["nn_grid_near"] += 1
    _build.check(code, "nn_grid")
    count_later(_k4_counters, counts, cap, nj, tm, scene_tile, scratch[ni + 3])
    return d2, idx, y, pl


def tile_ids(cand: torch.Tensor, nj: int, ti: int, cnt: int):
    """The model tiles scene tile ``ti`` folds, in the kernels' order: its
    candidates, or every tile when its count passes the table's capacity."""
    if cnt > cand.shape[1]:
        return torch.arange(nj, device=cand.device)
    return cand[ti, :max(cnt, 1)].to(torch.int64)


def work_item_offsets(counts: torch.Tensor, cap: int, nj: int) -> torch.Tensor:
    """(Ni + 1,) int32: each scene tile's first work item of K4 and, last,
    the total.  A work item is one model tile of a scene tile's fold list
    (``tile_ids``); the kernel's plan step computes the same."""
    c = counts.long()
    lens = torch.where(c > cap, torch.full_like(c, nj), c.clamp(min=1))
    zero = torch.zeros(1, dtype=torch.int64, device=counts.device)
    return torch.cat([zero, lens.cumsum(0)]).to(torch.int32)


def folded_pairs(counts: torch.Tensor, cap: int, nj: int, tm: int, tn: int) -> int:
    """(query, model row) pairs a work-list launch (K4, K7) folds for this
    table: one query tile of ``tn`` rows against one model tile of ``tm``
    rows per tile of its fold list (``tile_ids``)."""
    return int(work_item_offsets(counts, cap, nj)[-1]) * tm * tn


def _k4_counters(counts, cap: int, nj: int, tm: int, tn: int, skipped=None) -> dict:
    """K4's tracing counters of one launch (``utils/profiling.py``): its
    items are its fold list's, its table's pairs theirs, its pairs those
    of the items it folded; ``skipped``, the launch's device count of
    skipped items (None: the plain version, which skips none)."""
    items = int(work_item_offsets(counts, cap, nj)[-1])
    skipped = 0 if skipped is None else int(skipped)
    return {"k4_rows": counts.shape[0] * tn, "k4_items": items, "k4_items_skipped": skipped,
            "k4_table_pairs": items * tm * tn, "k4_pairs": (items - skipped) * tm * tn,
            "k4_tiles": counts.shape[0], "k4_tiles_past_cap": int((counts > cap).sum())}


def nn_grid_plain(cand, counts, scene, tiles, scene_tile, payload=None, *, kd_row):
    """Plain version of K4: per scene tile, the lexicographic minimum of
    (diff-squares distance, original index) over its candidate tiles; the
    winner's point and payload row are read through ``kd_row``, as the
    kernel's epilogue reads them (a padding winner reads zeros).  A NaN
    distance never wins (the kernel's ``d <= best``): a row with none
    other gets d2 = +inf and index -1."""
    nj = tiles.shape[0]
    dev = scene.device
    n = scene.shape[0]
    d2 = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    for ti, cnt in enumerate(counts.tolist()):
        ids = tile_ids(cand, nj, ti, cnt)
        rows = tiles[ids].reshape(-1, 4)
        lo = ti * scene_tile
        p = scene[lo:lo + scene_tile]
        dx = p[:, None, 0] - rows[None, :, 0]
        dy = p[:, None, 1] - rows[None, :, 1]
        dz = p[:, None, 2] - rows[None, :, 2]
        d = (dx * dx + dy * dy) + dz * dz
        best = torch.where(torch.isnan(d), float("inf"), d).amin(1)  # a NaN never wins
        key = torch.where(d == best[:, None], rows[None, :, 3], big)
        oidx = key.amin(1)
        d2[lo:lo + scene_tile] = best
        idx[lo:lo + scene_tile] = torch.where(
            oidx < 16777216.0, oidx, torch.full_like(oidx, -1.0)).to(torch.int32)
    real = (idx >= 0)[:, None]
    row = kd_row[idx.clamp(min=0).long()].long()
    y = torch.where(real, tiles.reshape(-1, 4)[row, :3], 0.0)
    pl = None if payload is None else torch.where(real, payload.reshape(-1, 4)[row], 0.0)
    return d2, idx, y, pl


def closest_point_indices_pruned(scene: torch.Tensor, grid: ModelGrid,
                                 u: torch.Tensor, *, scene_tile: int = 256,
                                 max_candidates: int = 16):
    """Exact NN via tile culling: (indices, matched points, payload rows or
    None, squared distances, overflow), always equal to brute force
    (squared distance, lowest original index on ties).  ``u``: (N,) upper
    bounds on each point's squared NN distance; ``overflow``: some tile
    folded all tiles.  The payload rows are the (N, k) values packed by
    ``build_model_grid(payload=...)``."""
    n = scene.shape[0]
    scene = scene.to(torch.float32)
    tn = min(scene_tile, _round_up(n, 8))
    n_pad = _round_up(n, tn)
    nj = grid.tile_lo.shape[0]
    cap = min(max_candidates, nj)
    u = u.to(torch.float32)
    if n_pad > n:  # replicate the last point: tile boxes stay tight
        scene = torch.cat([scene, scene[-1:].expand(n_pad - n, 3)])
        u = torch.cat([u, u[-1:].expand(n_pad - n)])
    scene = scene.contiguous()
    cand, counts, overflow = candidates(scene, u, grid, scene_tile=tn, cap=cap)
    d2, idx, y, pl = nn_grid(cand, counts, scene, grid, tn, grid.payload)
    pl = None if pl is None else pl[:n, :grid.payload_width]
    return idx[:n], y[:n], pl, d2[:n], overflow


def closest_point_indices_grid(scene: torch.Tensor, grid: ModelGrid,
                               u: torch.Tensor, *, scene_tile: int = 256,
                               max_candidates: int = 16):
    """(indices, matched points, payload rows or None, squared distances):
    ``closest_point_indices_pruned`` without the overflow flag."""
    idx, y, pl, d2, _ = closest_point_indices_pruned(
        scene, grid, u, scene_tile=scene_tile, max_candidates=max_candidates)
    return idx, y, pl, d2
