"""Carry state between ``icp_tpu`` (JAX) and this package.

Works on numpy arrays only, so neither side imports the other: pass the JAX
package's values through ``np.asarray`` (a JAX ``Similarity`` is a triple
``s, R, t``; its state block is (1, 32) float32; a JAX ``ModelGrid`` is a
named tuple of arrays), and build the JAX ``Similarity`` from the triple
returned here.  Tests use this to start both engines from the same
``init=``, the same normals and the same model grid, and to compare state
blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from icp_tpu_torch.ops.alignment import Similarity


def similarity_from_numpy(sim, dtype=torch.float32, device=None) -> Similarity:
    """Any ``(s, R, t)`` triple of array-likes -> this package's Similarity."""
    s, R, t = (np.asarray(v, dtype=np.float64) for v in sim)
    return Similarity(*(torch.as_tensor(v).to(dtype=dtype, device=device)
                        for v in (s, R, t)))


def similarity_to_numpy(sim: Similarity):
    """This package's Similarity -> ``(s, R, t)`` float64 numpy arrays."""
    return tuple(v.detach().to(torch.float64).cpu().numpy() for v in sim)


def state_from_jax(state, device=None) -> torch.Tensor:
    """The JAX (1, 32) float32 state block -> this package's float64 block
    (same slots)."""
    a = np.asarray(state, dtype=np.float64).reshape(1, 32)
    return torch.as_tensor(a).to(device=device)


def state_to_jax(state: torch.Tensor) -> np.ndarray:
    """This package's state block -> the JAX layout, (1, 32) float32."""
    return state.detach().cpu().numpy().astype(np.float32).reshape(1, 32)


def points_from_numpy(a, dtype=torch.float32, device=None) -> torch.Tensor:
    """An (N, k) array-like (points, normals) -> a tensor of ``dtype``."""
    return torch.as_tensor(np.array(a)).to(dtype=dtype, device=device)


def model_grid_from_jax(grid, device=None):
    """A JAX ``ModelGrid`` -> this package's: the transposed (Nj, 8, tm)
    tiles become (Nj, tm, 4) rows (x, y, z, original index), and the payload
    sublanes 4.. a kd-ordered (Nj, tm, 4) payload."""
    from icp_tpu_torch.kernels.nn_grid import ModelGrid

    tiles_t = np.asarray(grid.tiles_t, dtype=np.float32)
    rows = np.ascontiguousarray(tiles_t.transpose(0, 2, 1))  # (Nj, tm, 8)
    payload, width = None, 0
    if grid.payload_orig is not None:
        width = np.asarray(grid.payload_orig).shape[1]
        payload = np.zeros(rows.shape[:2] + (4,), np.float32)
        payload[..., :width] = rows[..., 4:4 + width]
        payload = points_from_numpy(payload, device=device)
    oidx = rows[..., 3].reshape(-1)
    real = np.flatnonzero(oidx < 2.0 ** 24)  # padding rows carry 3e38
    kd_row = np.zeros(np.asarray(grid.model_orig).shape[0], np.int32)
    kd_row[oidx[real].astype(np.int64)] = real
    return ModelGrid(
        tiles=points_from_numpy(np.ascontiguousarray(rows[..., :4]), device=device),
        tile_lo=points_from_numpy(grid.tile_lo, device=device),
        tile_hi=points_from_numpy(grid.tile_hi, device=device),
        model_orig=points_from_numpy(grid.model_orig, device=device),
        kd_row=torch.as_tensor(kd_row).to(device=device),
        model_tile=int(grid.model_tile),
        payload=payload,
        payload_width=width,
    )
