"""K1: dense exact nearest neighbour (``csrc/nn_dense.cu``).

Port of ``icp_tpu/kernels/nn_pallas.py`` (``_nn_kernel``, the diff-squares
form).  For every scene point: the model index of the least squared
distance ``(dx*dx + dy*dy) + dz*dz`` in float32, ties to the lowest index,
and optionally that distance.  ``nn_dense_plain`` is the same function in
plain torch, in scene blocks so the N x M matrix never exists beyond one
block; the wrapper takes it only for CPU tensors.
"""

from __future__ import annotations

import torch

from icp_tpu_torch.kernels import _build

_PLAIN_BLOCK_ELEMS = 1 << 24  # distance elements per block of the plain version


def check_points(fn: str, name: str, t: torch.Tensor, device=None) -> None:
    """Raise unless ``t`` is a contiguous float32 (N, 3) tensor on ``device``."""
    if t.ndim != 2 or t.shape[1] != 3 or t.dtype != torch.float32 \
            or not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be a contiguous float32 (N, 3) "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected {device}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {t.device}")


def nn_dense(scene: torch.Tensor, model: torch.Tensor, *, with_dist: bool = False):
    """(N,) int32 nearest-model indices [, (N,) float32 squared distances]."""
    check_points("nn_dense", "scene", scene)
    check_points("nn_dense", "model", model, scene.device)
    if model.shape[0] < 1:
        raise ValueError("nn_dense: empty model")
    if scene.device.type == "cpu":
        return nn_dense_plain(scene, model, with_dist=with_dist)
    n, m = scene.shape[0], model.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=scene.device)
    d2 = torch.empty(n, dtype=torch.float32, device=scene.device) if with_dist else None
    if n:
        code = _build.lib().nn_dense_launch(
            scene.data_ptr(), n, model.data_ptr(), m, idx.data_ptr(),
            None if d2 is None else d2.data_ptr(), _build.stream_ptr(scene))
        _build.LAUNCHES["nn_dense"] += 1
        _build.check(code, "nn_dense")
    return (idx, d2) if with_dist else idx


def nn_dense_plain(scene: torch.Tensor, model: torch.Tensor, *,
                   with_dist: bool = False):
    """Plain version of K1: same distance order, first index of the minimum."""
    n, m = scene.shape[0], model.shape[0]
    rows = max(1, _PLAIN_BLOCK_ELEMS // m)
    idx = torch.empty(n, dtype=torch.int32, device=scene.device)
    d2 = torch.empty(n, dtype=torch.float32, device=scene.device)
    for lo in range(0, n, rows):
        p = scene[lo:lo + rows]
        dx = p[:, None, 0] - model[None, :, 0]
        dy = p[:, None, 1] - model[None, :, 1]
        dz = p[:, None, 2] - model[None, :, 2]
        d = (dx * dx + dy * dy) + dz * dz
        best, arg = torch.min(d, dim=1)  # first index of the minimum
        idx[lo:lo + rows] = arg.to(torch.int32)
        d2[lo:lo + rows] = best
    return (idx, d2) if with_dist else idx


def closest_point_indices_dense(scene: torch.Tensor, model: torch.Tensor) -> torch.Tensor:
    """Nearest-model-point indices (clouds cast to contiguous float32)."""
    return nn_dense(scene.to(torch.float32).contiguous(),
                    model.to(torch.float32).contiguous())
