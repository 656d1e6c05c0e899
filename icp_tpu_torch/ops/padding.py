"""Bucket padding: one cloud shape for a whole scan chain (port of
``icp_tpu/ops/padding.py``).

Pad every cloud up to a quantized bucket size and carry the true row count
beside it (``scene_n`` / ``model_n`` of the engines).  Two conventions
cooperate, as in the JAX package:

  * **Sentinel padding** (``pad_to_bucket``, numpy, on the host): pad rows
    sit at ``SENTINEL`` = 1e17.  Distances from real points to sentinels
    are ~3e34 (finite in float32, never an argmin winner), so NN searches
    and the kNN normals of the padded cloud are exact for the real rows.
  * **Replica filling** (``replica_fill``, torch, inside the engines):
    before registration the engines overwrite pad rows with a copy of the
    last real row, which keeps kd tiles compact; a replica never wins a tie
    over its original (lowest index wins), and pad rows carry weight 0
    (``valid_mask``) in every sum, trim quantile and error mean.

Workflow::

    m_pad, m_n = pad_to_bucket(model);  s_pad, s_n = pad_to_bucket(scene)
    icp(m_pad, s_pad, cfg, model_n=m_n, scene_n=s_n)

The numpy functions are copies of the JAX module's, kept here so this
package imports nothing of it.
"""

from __future__ import annotations

import numpy as np
import torch

# Far-away pad coordinate: squared distances to real points are ~3e34 —
# finite in float32 and never an argmin winner.
SENTINEL = 1.0e17


def auto_quantum(n_max: int) -> int:
    """Default bucket quantum for a chain whose largest cloud has ``n_max``
    rows: the smallest power of two >= n_max/8, clamped to [64, 4096]."""
    if n_max <= 0:
        raise ValueError(f"auto_quantum needs n_max >= 1, got {n_max}")
    target = (n_max + 7) // 8
    return min(4096, max(64, 1 << max(0, target - 1).bit_length()))


def resolve_auto_bucket(clouds, device) -> int | None:
    """The chain-level "auto" policy for a chain registered on ``device``:
    on the CPU, as in JAX, ``auto_quantum`` of the largest cloud when the
    chain has unequal cloud sizes, None when all share one.  On the card
    None: the buckets serve the TPU's compile cache, which the card does
    not have, and ``scripts/dispatch_sweep.py`` measured the bunny chain
    (NVIDIA H100 80GB HBM3, 700 W) slower bucketed on the dense paths, the
    same on the grid, with the same pairs' iterations and errors."""
    if torch.device(device).type == "cuda":
        return None
    sizes = {len(c) for c in clouds}
    return auto_quantum(max(sizes)) if len(sizes) > 1 else None


def bucket_size(n: int, quantum: int = 4096) -> int:
    """Smallest multiple of ``quantum`` >= n (the bucket shape)."""
    if n <= 0:
        raise ValueError(f"bucket_size needs n >= 1, got {n}")
    return -(-n // quantum) * quantum


def pad_to_bucket(cloud, quantum: int = 4096, n_pad: int | None = None):
    """Sentinel-pad an (n, d) host cloud to its bucket; returns
    ``(padded, n)``: an (bucket, d) ndarray and the true row count to pass
    as the engine's ``scene_n`` / ``model_n``.  ``n_pad`` overrides the
    bucket (>= n), so two clouds can share one shape."""
    cloud = np.asarray(cloud)
    n = cloud.shape[0]
    b = bucket_size(n, quantum) if n_pad is None else int(n_pad)
    if b < n:
        raise ValueError(f"n_pad={b} smaller than cloud rows {n}")
    if b == n:
        return cloud, n
    out = np.full((b,) + cloud.shape[1:], SENTINEL, dtype=cloud.dtype)
    out[:n] = cloud
    return out, n


def replica_fill(cloud: torch.Tensor, n_valid) -> torch.Tensor:
    """Rows >= ``n_valid`` (an int or a 0-d tensor) overwritten with a copy
    of row ``n_valid - 1``, with no host read of the count."""
    n = torch.as_tensor(n_valid, device=cloud.device).to(torch.int64)
    row = cloud.index_select(0, (n - 1).reshape(1))
    keep = torch.arange(cloud.shape[0], device=cloud.device) < n
    return torch.where(keep[:, None], cloud, row)


def valid_mask(n_rows: int, n_valid, dtype, device=None) -> torch.Tensor:
    """(n_rows,) mask: 1 for rows < ``n_valid``, else 0."""
    n = torch.as_tensor(n_valid, device=device).to(torch.int64)
    return (torch.arange(n_rows, device=device) < n).to(dtype)
