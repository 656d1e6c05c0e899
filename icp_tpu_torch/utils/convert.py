"""Carry state between ``icp_tpu`` (JAX) and this package.

Works on numpy arrays only, so neither side imports the other: pass the JAX
package's values through ``np.asarray`` (a JAX ``Similarity`` is a triple
``s, R, t``; its state block is (1, 32) float32), and build the JAX
``Similarity`` from the triple returned here.  Tests use this to start both
engines from the same ``init=`` and to compare state blocks.
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
