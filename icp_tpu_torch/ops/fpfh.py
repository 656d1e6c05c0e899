"""FPFH point features (port of ``icp_tpu/ops/fpfh.py``).

Fast Point Feature Histograms (Rusu et al., ICRA 2009): a 33-dimensional
rotation-invariant descriptor a point, the feature of global registration
(``engine/global_reg.py``).  The neighbour sets come from the kNN kernels,
K6 (``kernels/knn_dense.py``) below 16,384 points and K7
(``kernels/knn_grid.py``) from there up, as ``ops/normals.knn_indices``
picks them; one kNN call fetches ``max(k + 1, orient_k)`` neighbours (64 by
default, so the kernels' lists of two slots a lane) and both uses slice it.
The three Darboux-frame angles of every (point, neighbour) pair are one
vectorised pass; each histogram counts 0/1 weights with a scatter-add,
exact in any order, where JAX sums a one-hot.

Normals are oriented away from their local neighbourhood mean
(``orient_local``): rotation-equivariant and stable under cropping, which
feature matching across partially overlapping views needs (the JAX
module's docstring gives the measurement).
"""

from __future__ import annotations

import math

import torch

from icp_tpu_torch.utils.precision import in_full_float32

N_BINS = 11  # a histogram's bins an angle: 3 angles, a 33-D descriptor (PCL's FPFH33)


def _safe_normalize(v, eps=1e-12):
    return v * torch.rsqrt((v * v).sum(-1, keepdim=True).clamp(min=eps))


def _flip(normals, sign):
    return normals * torch.where(sign == 0, torch.ones_like(sign), sign)


def orient_outward(points: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """Flip each normal away from the cloud's centroid (rotation-equivariant,
    but not stable under cropping: see ``orient_local``)."""
    mu = points.mean(0, keepdim=True)
    return _flip(normals, torch.sign(((points - mu) * normals).sum(1, keepdim=True)))


def orient_local(points: torch.Tensor, normals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Flip each normal away from the mean of its (N, K) neighbours ``idx``
    (self allowed)."""
    nb_mu = points[idx.long()].mean(1)
    return _flip(normals, torch.sign(((points - nb_mu) * normals).sum(1, keepdim=True)))


def _pair_angles(p, n, q, nq, eps=1e-12):
    """Darboux-frame features of point pairs: u = n, v = unit(d) x u,
    w = u x v, alpha = v . nq, phi = u . unit(d), theta = atan2(w . nq,
    u . nq); returns (alpha, phi, theta, |d|)."""
    d = q - p
    dist = torch.sqrt((d * d).sum(-1).clamp(min=eps))
    du = d / dist[..., None]
    n = n.expand_as(du)
    v = _safe_normalize(torch.linalg.cross(du, n, dim=-1), eps)
    w = torch.linalg.cross(n, v, dim=-1)
    alpha = (v * nq).sum(-1)
    phi = (n * du).sum(-1)
    theta = torch.atan2((w * nq).sum(-1), (n * nq).sum(-1))
    return alpha, phi, theta, dist


def _bin11(x, lo, hi):
    """The 11-bin index of x in [lo, hi] (clamped)."""
    t = (x - lo) / (hi - lo)
    return (t * N_BINS).to(torch.int32).clamp(0, N_BINS - 1)


def _spfh(points, normals, idx):
    """Simplified Point Feature Histograms of (N, 3) points and normals over
    (N, k) neighbours (self pairs masked): (spfh (N, 33), pair weights
    (N, k), pair distances (N, k))."""
    dt = points.dtype
    n_pts, k = idx.shape
    il = idx.long()
    alpha, phi, theta, dist = _pair_angles(points[:, None, :], normals[:, None, :],
                                           points[il], normals[il])
    self_pair = il == torch.arange(n_pts, device=idx.device)[:, None]
    w_pair = (~self_pair).to(dt)
    bins = torch.stack([_bin11(alpha, -1.0, 1.0), _bin11(phi, -1.0, 1.0),
                        _bin11(theta, -math.pi, math.pi)])  # (3, N, k)
    hist = torch.zeros((3, n_pts, N_BINS), dtype=dt, device=points.device).scatter_add_(
        2, bins.long(), w_pair.expand(3, n_pts, k).contiguous())
    spfh = torch.cat([hist[0], hist[1], hist[2]], dim=1)
    cnt = w_pair.sum(1, keepdim=True).clamp(min=1.0)
    return spfh / cnt, w_pair, dist


def fpfh_from_neighbors(points: torch.Tensor, normals: torch.Tensor, idx: torch.Tensor,
                        orient_idx: torch.Tensor | None = None) -> torch.Tensor:
    """FPFH descriptors from (N, k) neighbour indices: FPFH(p) = SPFH(p) +
    (1/|Nb|) sum_j SPFH(q_j) / omega_j (omega_j the pair distance), each
    11-bin block then L1-normalised to 100.  Normals are re-oriented with
    ``orient_local`` over ``orient_idx`` (default ``idx``)."""
    normals = orient_local(points, normals, idx if orient_idx is None else orient_idx)
    spfh, w_pair, dist = _spfh(points, normals, idx)
    inv_w = w_pair / dist.clamp(min=1e-6)  # 0 on self pairs
    cnt = w_pair.sum(1, keepdim=True).clamp(min=1.0)
    mix = torch.einsum("nk,nkf->nf", inv_w, spfh[idx.long()]) / cnt
    blocks = (spfh + mix).reshape(-1, 3, N_BINS)
    s = blocks.sum(2, keepdim=True).clamp(min=1e-12)
    return (100.0 * blocks / s).reshape(-1, 3 * N_BINS).to(points.dtype)


@in_full_float32
def fpfh_features(points, *, k: int = 32, orient_k: int = 64, normals=None,
                  method: str = "auto", device=None) -> torch.Tensor:
    """(N, 3) cloud -> (N, 33) FPFH descriptors.

    ``k``: the neighbourhood of the normals and the histograms; ``orient_k``:
    the larger one of the normals' sign (one kNN call fetches
    ``max(k + 1, orient_k)``).  ``normals``: optional (N, 3) unit normals of
    any sign.  ``method``: the kNN kernel as ``ops/normals.knn_indices``
    takes it (``"auto"``: K7 from 16,384 points, else K6).  Devices as in
    ``icp``: numpy input goes to the card unless ``device="cpu"``."""
    from icp_tpu_torch.engine.icp import as_points
    from icp_tpu_torch.ops.normals import knn_indices, normals_from_neighbor_indices

    dtype = points.dtype if isinstance(points, torch.Tensor) else torch.float32
    pts = as_points(points, dtype, device)
    n = pts.shape[0]
    k_eff = min(k + 1, n)  # the point itself, masked out of the histograms
    idx_fetch = knn_indices(pts, min(max(k + 1, orient_k), n), method=method)
    idx = idx_fetch[:, :k_eff]
    if normals is None:
        normals = normals_from_neighbor_indices(pts, idx)
    else:
        normals = torch.as_tensor(normals).to(dtype=pts.dtype, device=pts.device)
    return fpfh_from_neighbors(pts, normals, idx, orient_idx=idx_fetch)
