"""Exact nearest neighbours in plain PyTorch, float64, on any device.

A KD-tree on the host visits thousands of points for each query that lies
far from a dense surface, as the first iterations of a registration do
(a 1,000,000-point horse takes it tens of seconds a search), so the
reference searches on the run's device instead, by blocks:

1. the model's points are ordered along a Morton curve and cut into blocks
   of ``block`` rows, the queries likewise into tiles;
2. every ``SEED_STRIDE``-th model point is a seed; each query's distance
   to its nearest seed bounds its nearest distance from above, and the
   largest of these over a tile bounds the tile's;
3. a block can hold a tile's nearest point only if the distance between
   their bounding boxes is within that bound; every such pair is searched
   by brute force.

A pair's squared distances are ``|q|^2 + |m|^2 - 2 q.m`` in float64 with
both sides first moved to the tile's centre, so that the rounding is
relative to the pair's own scale (about 1e-16 of the squared distance
plus 1e-16 of the squared size of the tile and the block), far below
float32's.  The answer is the nearest model row by that distance, the
lowest row on ties; rows at the same point always tie.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 128
SEED_STRIDE = 64
_ENTRIES = 1 << 27  # distances computed at once: 1 GiB of float64


def _spread(v: torch.Tensor) -> torch.Tensor:
    """The low 10 bits of ``v`` moved to every third bit."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def _morton_order(x: torch.Tensor, lo: torch.Tensor, span: torch.Tensor) -> torch.Tensor:
    q = ((x - lo) / span * 1023.0).clamp(0, 1023).to(torch.int64)
    return torch.argsort(_spread(q[:, 0]) | (_spread(q[:, 1]) << 1) | (_spread(q[:, 2]) << 2),
                         stable=True)


def _blocks(x: torch.Tensor, order: torch.Tensor, block: int):
    """(rows (T, block), points (T, block, 3), box lo (T, 3), box hi (T, 3)):
    consecutive runs of ``order``, each block's rows ascending, the last
    block padded with the row count (a row past the end) at the first
    row's point."""
    n = order.shape[0]
    t = -(-n // block)
    rows = torch.full((t * block,), n, dtype=torch.int64, device=x.device)
    rows[:n] = order
    rows = rows.view(t, block).sort(1).values
    pts = x[torch.where(rows < n, rows, rows[:, :1])]
    return rows, pts, pts.amin(1), pts.amax(1)


def _sq_dist(a: torch.Tensor, b: torch.Tensor, centre: torch.Tensor) -> torch.Tensor:
    """Squared distances between the rows of ``a`` (..., i, 3) and ``b``
    (..., j, 3), both moved to ``centre`` (..., 3) first."""
    a = a - centre[..., None, :]
    b = b - centre[..., None, :]
    base = (a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :]
    return torch.baddbmm(base, a, b.transpose(-1, -2), alpha=-2.0).clamp_min_(0.0)


def _seed_bound(query: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """Each query's squared distance to its nearest seed, a hair wide."""
    out = torch.empty(query.shape[0], dtype=torch.float64, device=query.device)
    step = max(1, _ENTRIES // max(1, seeds.shape[0]))
    centre = seeds.mean(0)
    for a in range(0, query.shape[0], step):
        d = _sq_dist(query[None, a:a + step], seeds[None], centre[None])[0]
        out[a:a + step] = d.amin(1)
    scale = ((seeds - centre) ** 2).sum(1).max() + ((query - centre) ** 2).sum(1).max()
    return out * (1 + 1e-9) + 1e-14 * scale


def nearest(model, query, device="cpu", block: int = BLOCK) -> np.ndarray:
    """Index of each query row's nearest model row (exact, float64)."""
    dev = torch.device(device)
    m = torch.as_tensor(np.asarray(model, dtype=np.float64), device=dev)
    q = torch.as_tensor(np.asarray(query, dtype=np.float64), device=dev)
    lo = torch.minimum(m.amin(0), q.amin(0))
    span = (torch.maximum(m.amax(0), q.amax(0)) - lo).clamp_min(1e-300)
    m_order = _morton_order(m, lo, span)
    m_rows, m_pts, m_lo, m_hi = _blocks(m, m_order, block)
    q_rows, q_pts, q_lo, q_hi = _blocks(q, _morton_order(q, lo, span), block)
    n_m, n_q = m.shape[0], q.shape[0]

    ub = _seed_bound(q, m[m_order[::SEED_STRIDE]])
    tile_ub = torch.where(q_rows < n_q, ub[q_rows.clamp_max(n_q - 1)], 0.0).amax(1)
    centre = 0.5 * (q_lo + q_hi)

    best_d = torch.full((n_q,), float("inf"), dtype=torch.float64, device=dev)
    best_i = torch.full((n_q,), n_m, dtype=torch.int64, device=dev)
    group = max(1, (1 << 24) // m_rows.shape[0])  # tiles a box test takes at once
    pairs = max(1, _ENTRIES // (block * block))
    for a in range(0, q_rows.shape[0], group):
        gap = (torch.clamp(m_lo[None] - q_hi[a:a + group, None], min=0)
               + torch.clamp(q_lo[a:a + group, None] - m_hi[None], min=0))
        tiles, blocks = ((gap * gap).sum(-1) <= tile_ub[a:a + group, None]).nonzero(as_tuple=True)
        tiles = tiles + a
        for b in range(0, tiles.shape[0], pairs):
            ti, bi = tiles[b:b + pairs], blocks[b:b + pairs]
            d = _sq_dist(q_pts[ti], m_pts[bi], centre[ti])
            rows = m_rows[bi]
            d.masked_fill_((rows >= n_m)[:, None, :], float("inf"))
            # a block's rows ascend, so the first of equal minima is the lowest row
            dmin, at = d.min(2)
            imin = rows.gather(1, at)
            qr = q_rows[ti]
            keep = qr < n_q
            _merge(best_d, best_i, qr[keep], dmin[keep], imin[keep])
    return best_i.cpu().numpy()


def _merge(best_d, best_i, qr, d, i) -> None:
    """Fold candidates (query row, squared distance, model row) into the
    best so far: the smaller distance, then the lower model row."""
    uq, inv = torch.unique(qr, return_inverse=True)
    cd = torch.full(uq.shape, float("inf"), dtype=d.dtype, device=d.device)
    cd.scatter_reduce_(0, inv, d, "amin")
    tie = d == cd[inv]
    ci = torch.full(uq.shape, torch.iinfo(torch.int64).max, dtype=torch.int64, device=d.device)
    ci.scatter_reduce_(0, inv[tie], i[tie], "amin")
    bd, bi = best_d[uq], best_i[uq]
    better = (cd < bd) | ((cd == bd) & (ci < bi))
    best_d[uq] = torch.where(better, cd, bd)
    best_i[uq] = torch.where(better, ci, bi)
