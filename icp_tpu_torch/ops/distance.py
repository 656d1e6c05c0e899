"""Closest-point correspondence search (port of ``icp_tpu/ops/distance.py``).

Reference contract: brute-force nearest neighbour by squared distance, ties
to the LOWEST model index (``src/cpu.cc:5-27``, ``src/GPU/compute.cu:137``).

  * ``bcast``: plain torch broadcast form in scene blocks (the N x M matrix
    never exists beyond one block).
  * ``matmul``: ``||m||^2 - 2 s.m`` expansion in a torch matmul, as JAX
    computes it outside any Pallas kernel; it needs full-float32 matmuls,
    which the entry points guarantee (``utils.precision.full_float32``).
  * ``pallas``: the dense CUDA kernel K1 (``kernels/nn_dense.py``); the
    name is the JAX package's config string.
  * ``bf16``: APPROXIMATE — the bf16 prefilter K9 (``kernels/nn_bf16.py``)
    with its exact recheck; an index may be any candidate within the bf16
    cross-term band of the nearest.  Never chosen by ``auto``.

All return int32 indices into the model.
"""

from __future__ import annotations

import torch

_BLOCK_ELEMS = 1 << 24


def _blocked_argmin(scene: torch.Tensor, model: torch.Tensor, dist) -> torch.Tensor:
    rows = max(1, _BLOCK_ELEMS // max(model.shape[0], 1))
    return torch.cat([torch.argmin(dist(scene[lo:lo + rows], model), dim=1)
                      for lo in range(0, scene.shape[0], rows)]).to(torch.int32)


def squared_distances(scene: torch.Tensor, model: torch.Tensor) -> torch.Tensor:
    """Dense N x M squared-distance matrix (test/debug utility)."""
    return ((scene[:, None, :] - model[None, :, :]) ** 2).sum(-1)


def closest_point_indices_bcast(scene: torch.Tensor, model: torch.Tensor) -> torch.Tensor:
    return _blocked_argmin(scene, model, squared_distances)


def closest_point_indices_matmul(scene: torch.Tensor, model: torch.Tensor) -> torch.Tensor:
    """``||m||^2 - 2 s.m``: the per-row ``||s||^2`` cannot change the argmin."""
    m2 = (model * model).sum(1)
    return _blocked_argmin(scene, model,
                           lambda s, m: m2[None, :] - 2.0 * (s @ m.T))


def closest_point_indices(scene: torch.Tensor, model: torch.Tensor, *,
                          method: str = "auto") -> torch.Tensor:
    """Dispatching wrapper; ``method`` in {auto, bcast, matmul, pallas, bf16}.
    ``auto`` is the kernel on the card and ``bcast`` elsewhere."""
    if method == "auto":
        method = "pallas" if scene.device.type == "cuda" else "bcast"
    if method == "bcast":
        return closest_point_indices_bcast(scene, model)
    if method == "matmul":
        return closest_point_indices_matmul(scene, model)
    if method == "pallas":
        from icp_tpu_torch.kernels.nn_dense import closest_point_indices_dense

        return closest_point_indices_dense(scene, model)
    if method == "bf16":
        from icp_tpu_torch.kernels.nn_bf16 import nearest_indices_bf16

        return nearest_indices_bf16(scene, model)
    raise ValueError(f"unknown nn method: {method}")
