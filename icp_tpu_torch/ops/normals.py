"""Surface normals from k-nearest-neighbour PCA (port of
``icp_tpu/ops/normals.py``).

The neighbours come from the kNN kernels: K6 (``kernels/knn_dense.py``)
below ``NORMALS_GRID_THRESHOLD`` points (``NORMALS_GRID_THRESHOLD_CUDA``
on the card) and K7 (``kernels/knn_grid.py``) from there up.  The normal is the smallest eigenvector of the neighbours'
covariance, in closed form (trigonometric eigenvalues and the largest
cross product of the rows of C - lambda_min I), as tensor ops with no
library eigensolver and no host read.  Orientation is arbitrary; the
point-to-plane residual is squared, and ``orient_normals`` flips them
towards a viewpoint where a caller needs it.
"""

from __future__ import annotations

import math

import torch

from icp_tpu_torch.config import grid_sizes
from icp_tpu_torch.engine.icp import as_points
from icp_tpu_torch.utils.precision import in_full_float32
from icp_tpu_torch.utils.profiling import span

# Smallest cloud at which ``method="auto"`` takes the grid kNN (K7): on the
# CPU the JAX package's value, so the plain versions take the reference's
# branches; on the card as ``scripts/dispatch_sweep.py`` measured it (NVIDIA
# H100 80GB HBM3, 700 W; k 17): K6 faster at every size up to 65,536 rows
# (beyond the spread of the passes up to 48,485), K7 (its plan, host read
# and kd sorts) from 131,072.
NORMALS_GRID_THRESHOLD = 16384
NORMALS_GRID_THRESHOLD_CUDA = 131072


def _det3(B: torch.Tensor) -> torch.Tensor:
    """Determinants of (..., 3, 3) by cofactors along the first row (no
    batched LU factorisation per point on the card)."""
    return (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0]))


def _smallest_eigvec_sym3(C: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., 3, 3):
    eigenvalues by the trigonometric closed form (Smith 1961), eigenvector as
    the largest cross product of two rows of (C - lambda_min I)."""
    dt = C.dtype
    eye = torch.eye(3, dtype=dt, device=C.device)
    scale = C.abs().amax(dim=(-1, -2), keepdim=True).clamp(min=1e-30)
    A = C / scale
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2])[..., None, None] / 3.0
    B = A - q * eye
    p2 = (B * B).sum(dim=(-1, -2))[..., None, None] / 6.0
    p = torch.sqrt(p2.clamp(min=1e-30))
    det_b = _det3(B / p)[..., None, None]
    r = torch.clamp(det_b / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    M = A - lam_min * eye
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    cross = torch.linalg.cross
    cands = torch.stack([cross(r0, r1, dim=-1), cross(r1, r2, dim=-1), cross(r2, r0, dim=-1)],
                        dim=-2)
    norms = (cands * cands).sum(-1)
    best = torch.argmax(norms, dim=-1)  # first of equal norms, as jnp.argmax
    v = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    return v * torch.rsqrt((v * v).sum(-1, keepdim=True).clamp(min=1e-30))


def normals_from_neighbor_indices(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N, 3) cloud + (N, k) neighbour indices -> (N, 3) unit normals (PCA of
    each neighbourhood's covariance)."""
    nbrs = points[idx.to(torch.int64)]  # (N, k, 3)
    cent = nbrs - nbrs.mean(dim=1, keepdim=True)
    C = torch.einsum("cki,ckj->cij", cent, cent)
    return _smallest_eigvec_sym3(C)


@in_full_float32
def knn_indices(points: torch.Tensor, k: int, *, method: str = "auto",
                grid_scene_tile: int | None = None, grid_model_tile: int | None = None,
                grid_max_candidates: int | None = None) -> torch.Tensor:
    """(N, k) indices of each point's k nearest points, itself included:
    K6 (``"dense"``) or K7 (``"grid"``); ``"auto"`` is the grid from
    ``NORMALS_GRID_THRESHOLD`` points (``NORMALS_GRID_THRESHOLD_CUDA`` on
    the card).  K7's sizes left None are the device's
    (``config.grid_sizes(..., knn=True)``: query tile 64, model tile 256,
    capacity 32 on the CPU, as JAX's; 64 / 512 / 256 on the card)."""
    with span("icp.normals.knn", points):
        n = points.shape[0]
        if method == "auto":
            least = NORMALS_GRID_THRESHOLD_CUDA if points.is_cuda else NORMALS_GRID_THRESHOLD
            method = "grid" if n >= least else "dense"
        pts32 = points.to(torch.float32).contiguous()
        if method == "dense":
            from icp_tpu_torch.kernels.knn_dense import knn_dense

            return knn_dense(pts32, pts32, k)[1]
        if method != "grid":
            raise ValueError(f"unknown kNN method: {method}")
        from icp_tpu_torch.engine.grid import _prepare_scene
        from icp_tpu_torch.kernels.knn_grid import knn_grid
        from icp_tpu_torch.kernels.nn_grid import build_model_grid

        scene_tile, model_tile, cap = grid_sizes(points.device, grid_scene_tile,
                                                 grid_model_tile, grid_max_candidates, knn=True)
        grid = build_model_grid(pts32, target_tile=model_tile)
        # kd-sorted queries for tile coherence; the idx values are original
        # indices already, so only the rows are put back in order
        p_sorted, _, inv_slots, tn, _ = _prepare_scene(pts32, scene_tile)
        _, idx_sorted = knn_grid(p_sorted, grid, k, scene_tile=tn, max_candidates=cap)
        return idx_sorted[inv_slots]


@in_full_float32
def estimate_normals(points, k: int = 16, method: str = "auto",
                     grid_scene_tile: int | None = None, grid_model_tile: int | None = None,
                     grid_max_candidates: int | None = None, device=None) -> torch.Tensor:
    """(N, 3) cloud -> (N, 3) unit normals from k-nearest-neighbour PCA.

    The neighbours of each point are its ``min(k + 1, N)`` nearest points
    (itself among them), from K6 or K7 in float32 whatever the cloud's
    dtype; the PCA runs in the cloud's dtype (float32 for numpy input).
    ``method``: ``"dense"``, ``"grid"`` or ``"auto"`` (grid from 16,384
    points, 131,072 on the card), K7's sizes as ``knn_indices``'s.  Devices
    as in ``icp``: numpy input goes to the card unless ``device="cpu"``."""
    dtype = points.dtype if isinstance(points, torch.Tensor) else torch.float32
    pts = as_points(points, dtype, device)
    k_eff = min(k + 1, pts.shape[0])
    idx = knn_indices(pts, k_eff, method=method, grid_scene_tile=grid_scene_tile,
                      grid_model_tile=grid_model_tile,
                      grid_max_candidates=grid_max_candidates)
    with span("icp.normals.pca", pts):
        return normals_from_neighbor_indices(pts, idx)


def orient_normals(points: torch.Tensor, normals: torch.Tensor,
                   viewpoint=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """Flip normals to face ``viewpoint`` (the sensor origin)."""
    vp = torch.as_tensor(viewpoint, dtype=points.dtype, device=points.device)
    sign = torch.sign(((vp[None, :] - points) * normals).sum(1, keepdim=True))
    return normals * torch.where(sign == 0, torch.ones_like(sign), sign)
