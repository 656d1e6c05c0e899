"""Checkpoint and resume of registration state (port of
``icp_tpu/utils/checkpoint.py``).

A plain ``.npz`` with the JAX package's keys and types: ``s``, ``R``, ``t``
as float64, ``iteration`` int64, ``err`` float64 and, optionally,
``points`` float64.  A file that either package writes loads in the other.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from icp_tpu_torch.ops.alignment import Similarity


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().to(torch.float64).numpy()
    return np.asarray(x, np.float64)


def save_checkpoint(path: str, *, transform: Similarity, iteration: int, err: float,
                    points: Optional[np.ndarray] = None) -> None:
    """Write ``transform`` (tensors or arrays), the iteration count, the
    error and optionally the points to ``path`` (``np.savez``: a path
    without ``.npz`` gets it)."""
    data = dict(s=_f64(transform.s), R=_f64(transform.R), t=_f64(transform.t),
                iteration=np.int64(iteration), err=np.float64(err))
    if points is not None:
        data["points"] = _f64(points)
    np.savez(path, **data)


def load_checkpoint(path: str):
    """(Similarity of float64 CPU tensors, iteration, err, points as a
    float64 ndarray or None)."""
    with np.load(path) as z:
        sim = Similarity(*(torch.from_numpy(np.array(z[k], np.float64)) for k in ("s", "R", "t")))
        pts = np.array(z["points"]) if "points" in z.files else None
        return sim, int(z["iteration"]), float(z["err"]), pts
