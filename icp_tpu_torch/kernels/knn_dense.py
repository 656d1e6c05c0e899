"""K6: dense exact k nearest neighbours (``csrc/knn_dense.cu``).

Port of ``icp_tpu/kernels/knn_pallas.py`` (``knn_pallas``).  For every
query row: the k point indices of the least squared distances
``(dx*dx + dy*dy) + dz*dz`` in float32, and those distances, sorted
ascending by (distance, index), so ties go to the lowest index.
``knn_dense_plain`` is the same function in plain torch, in query blocks
with a stable sort of full rows; the wrapper takes it only for CPU tensors.
"""

from __future__ import annotations

import torch

from icp_tpu_torch.kernels import _build
from icp_tpu_torch.kernels.nn_dense import check_points

# The kernels' longest k-best list: 4 register slots a lane of a warp.  The
# JAX kernels take any k <= len(points); above this the wrappers raise (on
# the CPU too, so the two devices accept the same calls).
MAX_K = 128
_PLAIN_BLOCK_ELEMS = 1 << 24  # distance elements per block of the plain version


def check_k(fn: str, k: int, m: int) -> None:
    if k > m:
        raise ValueError(f"{fn}: k={k} exceeds point count {m}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{fn}: k={k} outside 1..{MAX_K}: the kNN kernels keep the "
                         f"k best in registers, at most {MAX_K}")


def knn_dense(query: torch.Tensor, points: torch.Tensor, k: int):
    """(d2 (N, k) float32, idx (N, k) int32), ascending by (d2, index)."""
    check_points("knn_dense", "query", query)
    check_points("knn_dense", "points", points, query.device)
    check_k("knn_dense", k, points.shape[0])
    if query.device.type == "cpu":
        return knn_dense_plain(query, points, k)
    n, m = query.shape[0], points.shape[0]
    d2 = torch.empty((n, k), dtype=torch.float32, device=query.device)
    idx = torch.empty((n, k), dtype=torch.int32, device=query.device)
    if n:
        code = _build.lib().knn_dense_launch(
            query.data_ptr(), n, points.data_ptr(), m, k, d2.data_ptr(),
            idx.data_ptr(), _build.stream_ptr(query))
        _build.LAUNCHES["knn_dense"] += 1
        _build.check(code, "knn_dense")
    return d2, idx


def knn_dense_plain(query: torch.Tensor, points: torch.Tensor, k: int):
    """Plain version of K6: same distance order; a stable sort of each full
    row keeps the lowest index among equal distances."""
    n, m = query.shape[0], points.shape[0]
    rows = max(1, _PLAIN_BLOCK_ELEMS // m)
    d2 = torch.empty((n, k), dtype=torch.float32, device=query.device)
    idx = torch.empty((n, k), dtype=torch.int32, device=query.device)
    for lo in range(0, n, rows):
        q = query[lo:lo + rows]
        dx = q[:, None, 0] - points[None, :, 0]
        dy = q[:, None, 1] - points[None, :, 1]
        dz = q[:, None, 2] - points[None, :, 2]
        d = (dx * dx + dy * dy) + dz * dz
        vals, order = torch.sort(d, dim=1, stable=True)
        d2[lo:lo + rows] = vals[:, :k]
        idx[lo:lo + rows] = order[:, :k].to(torch.int32)
    return d2, idx
