"""Voxel-grid downsampling (port of ``icp_tpu/ops/voxel.py``).

Each occupied voxel of a ``voxel_size`` lattice anchored at the cloud's
minimum is replaced by the centroid of its points: a 30-bit key per point
(10 bits an axis, clamped: the lattice covers 1024 voxels an axis), one
stable sort by key, and a segmented sum over the runs of equal keys into a
``capacity``-row output (voxels past it are dropped and reported by the
count, never merged).

The sum runs over each run of the sorted rows in order with
``torch.segment_reduce`` on the run lengths, as JAX's ``segment_sum`` adds
them: deterministic on the card too, where an ``index_add_`` would add
float32 rows by atomics in an order that changes from run to run.  The run
lengths are read to the host (one read a call; the output shape is the
caller's ``capacity`` all the same).
"""

from __future__ import annotations

import numpy as np
import torch

_BITS = 10  # a key's bits an axis: 30-bit keys in int32, as the JAX module
_GRID = 1 << _BITS


def voxel_downsample(points: torch.Tensor, voxel_size, *, capacity: int, n_valid=None):
    """Centroid-downsample ``points`` (N, 3) onto a ``voxel_size`` lattice.

    Returns ``(out, mask, n_voxels)``: ``out`` (capacity, 3) the voxel
    centroids in the first ``n_voxels`` rows (ordered by voxel key), zeros
    elsewhere; ``mask`` (capacity,) bool, the valid rows; ``n_voxels`` ()
    int32, the occupied voxels (above ``capacity`` when voxels were
    dropped).  ``n_valid``: the real rows of a padded cloud; rows at and
    past it join row 0's voxel with weight 0.  Points beyond 1024 voxels
    of the minimum clamp into the boundary voxels."""
    dt, dev = points.dtype, points.device
    n = points.shape[0]
    if n == 0:
        return (torch.zeros((capacity, 3), dtype=dt, device=dev),
                torch.zeros((capacity,), dtype=torch.bool, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    if n_valid is None:
        w = torch.ones(n, dtype=dt, device=dev)
    else:
        valid = torch.arange(n, device=dev) < int(n_valid)
        points = torch.where(valid[:, None], points, points[:1])
        w = valid.to(dt)
    v = torch.as_tensor(voxel_size, dtype=dt, device=dev)
    lo = points.amin(0)
    q = ((points - lo) / v).to(torch.int32).clamp(0, _GRID - 1)
    key = (q[:, 0] << (2 * _BITS)) | (q[:, 1] << _BITS) | q[:, 2]
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    w_s = w[order]
    lengths = torch.unique_consecutive(key_s, return_counts=True)[1]
    n_voxels = lengths.shape[0]
    sums = torch.segment_reduce(points[order] * w_s[:, None], "sum", lengths=lengths, axis=0)
    cnt = torch.segment_reduce(w_s, "sum", lengths=lengths)
    keep = min(n_voxels, capacity)
    out = torch.zeros((capacity, 3), dtype=dt, device=dev)
    count = torch.zeros(capacity, dtype=dt, device=dev)
    out[:keep] = sums[:keep]
    count[:keep] = cnt[:keep]
    mask = count > 0
    out = torch.where(mask[:, None], out / count.clamp(min=1.0)[:, None], 0.0)
    return out, mask, torch.tensor(n_voxels, dtype=torch.int32, device=dev)


def voxel_downsample_np(points, voxel_size, device=None):
    """Host helper: ``(centroids (n_voxels, 3) float32 ndarray, n_voxels)``
    of an (N, 3) cloud, computed in float32 on ``device`` (the card unless
    ``device="cpu"``, as the engines place numpy input).  JAX's pads the
    cloud to a power-of-two bucket for its compile cache; the pad rows
    weigh 0 and change no centroid, so the port runs the cloud as it is."""
    from icp_tpu_torch.engine.icp import as_points

    pts_np = np.asarray(points)
    n = pts_np.shape[0]
    if n == 0:
        return pts_np.reshape(0, 3).copy(), 0
    pts = as_points(pts_np, torch.float32, device)
    out, _, n_vox = voxel_downsample(pts, voxel_size, capacity=n)
    n_out = int(n_vox)
    return out[:n_out].cpu().numpy(), n_out
