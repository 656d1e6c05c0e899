"""K1, K10, K11 and K8: dense exact nearest neighbour (``csrc/nn_dense.cu``,
``csrc/nn_chunked.cu``).

Port of ``icp_tpu/kernels/nn_pallas.py``: ``_nn_kernel`` in its two
distance forms, the diff-squares ``(dx*dx + dy*dy) + dz*dz``
(``distance_impl="vpu"``, K1) and the expansion ``|m|^2 - 2 p.m``
(``distance_impl="mxu"``, K10), and ``_nn_kernel_chunked``
(``distance_impl="chunked"``, indices only, K8).  For every scene point:
the model index of the least distance in float32, ties to the lowest index,
and optionally (K1, K10) the squared distance; K10's is ``d + |p|^2`` with
no clamp, as JAX's (it can be slightly negative).  K1 and K10 are one CUDA
kernel with the form as a template parameter: a thread holds four scene
points and the model is split into chunks folded by separate blocks, whose
minima merge by a 64-bit ``atomicMin`` on (order-preserving distance bits,
index).  K8 splits the model axis over the 32 lanes of a warp (eight
scene points a warp), reduces the lanes' (d, idx) pairs by shuffles and
merges the model chunks the same way, in one launch whose last block of a
scene block writes its indices (``chunked_workspace``).  ``nn_dense_plain``
and ``nn_chunked_plain`` are their plain torch versions, in scene blocks so the
N x M matrix never exists beyond one block; the wrappers take them only for
CPU tensors.  No engine takes K8 or K10, as no JAX engine takes the chunked
or the ``"mxu"`` form: they are reached through ``distance_impl``.

``closest_points_and_targets_dense`` is K11, ``_nn_kernel``'s
``with_points`` form (JAX's ``closest_points_and_targets_pallas``): K1's
index and the winning model point, copied by K1's epilogue (the TPU's
one-hot gather matmul has no reason to exist on the card); its plain
version is ``nn_dense_points_plain``.  No engine takes it, as no JAX engine
takes that form.

``nn_dense_batched`` is K1 (K10) with a pair axis, the counterpart of JAX's
``vmap`` over the ``pallas_call``: B pairs of (N, 3) scenes and (M, 3)
models in one launch, the indices pair-local, each pair's output bit-equal
to ``nn_dense`` on that pair alone; ``nn_dense`` is its B = 1 case, and
``nn_dense_batched_plain`` is ``nn_dense_plain`` pair by pair.
"""

from __future__ import annotations

import ctypes

import torch

from icp_tpu_torch.kernels import _build

_PLAIN_BLOCK_ELEMS = 1 << 24  # distance elements per block of the plain version
_LANES = 32  # K8's model-axis split: the lanes of a warp
DISTANCE_IMPLS = ("vpu", "mxu", "chunked")
_FORMS = {"vpu": 0, "mxu": 1}  # the C entry points' distance form
_COUNTS = {"vpu": "nn_dense", "mxu": "nn_dense_mxu"}  # the launch count of each form


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


def _check_pair(fn: str, scene: torch.Tensor, model: torch.Tensor) -> None:
    check_points(fn, "scene", scene)
    check_points(fn, "model", model, scene.device)
    if model.shape[0] < 1:
        raise ValueError(f"{fn}: empty model")


def _check_batch(fn: str, scenes: torch.Tensor, models: torch.Tensor) -> None:
    """Raise unless ``scenes`` (B, N, 3) and ``models`` (B, M, 3) are
    contiguous float32 tensors on one device, M >= 1."""
    for name, t in (("scenes", scenes), ("models", models)):
        if t.ndim != 3 or t.shape[2] != 3 or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous float32 (B, N, 3) "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    if models.device != scenes.device or scenes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: scenes on {scenes.device}, models on {models.device}")
    if models.shape[0] != scenes.shape[0] or models.shape[1] < 1:
        raise ValueError(f"{fn}: {scenes.shape[0]} scenes against {models.shape[0]} models "
                         f"of {models.shape[1]} rows")


def _check_impl(fn: str, distance_impl: str, impls) -> None:
    if distance_impl not in impls:
        raise ValueError(f"{fn}: distance_impl must be one of {tuple(impls)}, "
                         f"got {distance_impl!r}")


def _launch(scene: torch.Tensor, model: torch.Tensor, pairs: int, with_dist: bool,
            distance_impl: str):
    """One launch of K1 (K10) on ``pairs`` (n, 3) scenes and (m, 3) models
    laid out one after another: (scene.shape[:-1]) int32 indices [and
    float32 distances]."""
    n, m = scene.shape[-2], model.shape[-2]
    shape = scene.shape[:-1]
    idx = torch.empty(shape, dtype=torch.int32, device=scene.device)
    d2 = torch.empty(shape, dtype=torch.float32, device=scene.device) if with_dist else None
    if n and pairs:
        keys = torch.empty(pairs * n, dtype=torch.int64, device=scene.device)  # (d2, index)
        code = _build.lib().nn_dense_launch(
            scene.data_ptr(), pairs, n, model.data_ptr(), m, _FORMS[distance_impl],
            keys.data_ptr(), idx.data_ptr(), None if d2 is None else d2.data_ptr(),
            _build.stream_ptr(scene))
        _build.LAUNCHES[_COUNTS[distance_impl]] += 1
        _build.check(code, _COUNTS[distance_impl])
    return (idx, d2) if with_dist else idx


def nn_dense(scene: torch.Tensor, model: torch.Tensor, *, with_dist: bool = False,
             distance_impl: str = "vpu"):
    """(N,) int32 nearest-model indices [, (N,) float32 squared distances].

    ``distance_impl``: ``"vpu"`` (K1), ``"mxu"`` (K10: the expansion form;
    its distance is ``|m|^2 - 2 p.m + |p|^2``) or ``"chunked"`` (K8,
    indices only: ``with_dist=True`` raises, as the JAX kernel asserts)."""
    _check_impl("nn_dense", distance_impl, DISTANCE_IMPLS)
    if distance_impl == "chunked":
        if with_dist:
            raise ValueError("nn_dense: distance_impl='chunked' returns indices only")
        return nn_chunked(scene, model)
    _check_pair("nn_dense", scene, model)
    if scene.device.type == "cpu":
        return nn_dense_plain(scene, model, with_dist=with_dist, distance_impl=distance_impl)
    return _launch(scene, model, 1, with_dist, distance_impl)


def nn_dense_batched(scenes: torch.Tensor, models: torch.Tensor, *, with_dist: bool = False,
                     distance_impl: str = "vpu"):
    """(B, N) int32 nearest-model indices of B pairs, each into its own
    model [, (B, N) float32 squared distances]: ``scenes`` (B, N, 3) and
    ``models`` (B, M, 3), contiguous float32.  On the card one launch of K1
    (``"vpu"``) or K10 (``"mxu"``) for all the pairs; each pair's output is
    ``nn_dense``'s on that pair."""
    _check_impl("nn_dense_batched", distance_impl, _FORMS)
    _check_batch("nn_dense_batched", scenes, models)
    if scenes.device.type == "cpu":
        return nn_dense_batched_plain(scenes, models, with_dist=with_dist,
                                      distance_impl=distance_impl)
    return _launch(scenes, models, scenes.shape[0], with_dist, distance_impl)


def chunk_rows(n: int, m: int, distance_impl: str = "vpu", pairs: int = 1) -> int:
    """The model rows of one of K1's (K10's) chunks for a launch of
    ``pairs`` (n, m) pairs on the current card (the C launcher's choice: one
    wave of blocks over all the pairs' scene blocks)."""
    out = ctypes.c_int()
    _build.check(_build.lib().nn_dense_chunk_rows(pairs, n, m, _FORMS[distance_impl],
                                                  ctypes.addressof(out)), "nn_dense")
    return out.value


def _norm3(x: torch.Tensor) -> torch.Tensor:
    """``(x*x + y*y) + z*z`` of each row, elementwise in that order."""
    return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2]


def nn_dense_plain(scene: torch.Tensor, model: torch.Tensor, *,
                   with_dist: bool = False, distance_impl: str = "vpu"):
    """Plain version of K1 (``"vpu"``) and K10 (``"mxu"``): the same
    distance in the same rounding order, elementwise (no matmul, so the card
    rounds it as the kernel does), the first index of the minimum.  In both
    forms a NaN ``d`` never wins and a row with no ``d < +inf`` gets index 0
    and +inf, as the kernel's strict ``d < best`` fold gives.  K10's:
    ``d = mn - 2c`` with ``mn = (mx*mx + my*my) + mz*mz`` and
    ``c = (px*mx + py*my) + pz*mz``, and the distance returned is ``d + pn``
    (``pn = (px*px + py*py) + pz*pz``)."""
    _check_impl("nn_dense_plain", distance_impl, _FORMS)
    n, m = scene.shape[0], model.shape[0]
    rows = max(1, _PLAIN_BLOCK_ELEMS // m)
    idx = torch.empty(n, dtype=torch.int32, device=scene.device)
    d2 = torch.empty(n, dtype=torch.float32, device=scene.device)
    mn = _norm3(model)
    for lo in range(0, n, rows):
        p = scene[lo:lo + rows]
        if distance_impl == "mxu":
            c = (p[:, None, 0] * model[None, :, 0] + p[:, None, 1] * model[None, :, 1]) \
                + p[:, None, 2] * model[None, :, 2]
            d = mn[None, :] - 2.0 * c
        else:
            dx = p[:, None, 0] - model[None, :, 0]
            dy = p[:, None, 1] - model[None, :, 1]
            dz = p[:, None, 2] - model[None, :, 2]
            d = (dx * dx + dy * dy) + dz * dz
        d = torch.where(torch.isnan(d), float("inf"), d)  # a NaN never wins
        best, arg = torch.min(d, dim=1)  # first index of the minimum
        idx[lo:lo + rows] = arg.to(torch.int32)
        d2[lo:lo + rows] = best
    if distance_impl == "mxu":
        d2 = torch.where(d2 < float("inf"), d2 + _norm3(scene), float("inf"))
    return (idx, d2) if with_dist else idx


def nn_dense_batched_plain(scenes: torch.Tensor, models: torch.Tensor, *,
                           with_dist: bool = False, distance_impl: str = "vpu"):
    """Plain version of ``nn_dense_batched``: ``nn_dense_plain`` pair by
    pair."""
    idx = torch.empty(scenes.shape[:-1], dtype=torch.int32, device=scenes.device)
    d2 = torch.empty(scenes.shape[:-1], dtype=torch.float32, device=scenes.device)
    for b, (s, m) in enumerate(zip(scenes, models)):
        idx[b], d2[b] = nn_dense_plain(s, m, with_dist=True, distance_impl=distance_impl)
    return (idx, d2) if with_dist else idx


def nn_chunked(scene: torch.Tensor, model: torch.Tensor) -> torch.Tensor:
    """K8: (N,) int32 nearest-model indices, equal to K1's."""
    _check_pair("nn_chunked", scene, model)
    if scene.device.type == "cpu":
        return nn_chunked_plain(scene, model)
    n, m = scene.shape[0], model.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=scene.device)
    if n:
        keys, counts = chunked_workspace(scene.device)
        code = _build.lib().nn_chunked_launch(
            scene.data_ptr(), n, model.data_ptr(), m, keys.data_ptr(), counts.data_ptr(),
            keys.shape[0], idx.data_ptr(), _build.stream_ptr(scene))
        _build.LAUNCHES["nn_chunked"] += 1
        _build.check(code, "nn_chunked")
    return idx


_CHUNKED_WORKSPACE: dict = {}  # (device index, stream) -> (keys, counts) of K8's launches


def chunked_workspace(device: torch.device):
    """K8's merge workspace for launches on the current stream of CUDA
    ``device``: (keys, counts), int64 all ones and int32 zeros, made on
    first use, on that stream, at the size of the largest launch that
    splits the model (one wave of scene blocks), and left so by every
    launch.  Launches on one stream run in order, so they share it; each
    stream has its own."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, _build.raw_stream(index))
    ws = _CHUNKED_WORKSPACE.get(key)
    if ws is None:
        points, blocks = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(index):
            _build.check(_build.lib().nn_chunked_workspace(ctypes.addressof(points),
                                                           ctypes.addressof(blocks)),
                         "nn_chunked")
            ws = (torch.full((points.value,), -1, dtype=torch.int64, device=index),
                  torch.zeros(blocks.value, dtype=torch.int32, device=index))
        _CHUNKED_WORKSPACE[key] = ws
    return ws


def chunked_chunk_rows(n: int, m: int) -> int:
    """The model rows of one of K8's chunks for an (n, m) launch on the
    current card (one wave of blocks, as K1's)."""
    out = ctypes.c_int()
    _build.check(_build.lib().nn_chunked_chunk_rows(n, m, ctypes.addressof(out)), "nn_chunked")
    return out.value


def nn_chunked_plain(scene: torch.Tensor, model: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: the model axis split over 32 lanes (row j on
    lane j % 32), each lane's first minimum over its rows, then the lowest
    index among the lanes that reach the least distance.  A NaN distance
    never wins, and a row with no distance below +inf gets index 0, as the
    kernel's strict ``d < best`` lanes give."""
    n, m = scene.shape[0], model.shape[0]
    chunks = -(-m // _LANES)
    rows = max(1, _PLAIN_BLOCK_ELEMS // (chunks * _LANES))
    lane = torch.arange(_LANES, device=scene.device)
    idx = torch.empty(n, dtype=torch.int32, device=scene.device)
    for lo in range(0, n, rows):
        p = scene[lo:lo + rows]
        dx = p[:, None, 0] - model[None, :, 0]
        dy = p[:, None, 1] - model[None, :, 1]
        dz = p[:, None, 2] - model[None, :, 2]
        d = (dx * dx + dy * dy) + dz * dz
        d = torch.where(torch.isnan(d), float("inf"), d)  # a NaN never wins
        d = torch.nn.functional.pad(d, (0, chunks * _LANES - m), value=float("inf"))
        best, chunk = torch.min(d.reshape(-1, chunks, _LANES), dim=1)  # first chunk
        gidx = chunk * _LANES + lane
        lane_min = best.amin(1, keepdim=True)
        key = torch.where(best == lane_min, gidx, torch.full_like(gidx, m))
        idx[lo:lo + rows] = key.amin(1).clamp(max=m - 1).to(torch.int32)
    return idx


def closest_point_indices_dense(scene: torch.Tensor, model: torch.Tensor, *,
                                distance_impl: str = "vpu") -> torch.Tensor:
    """Nearest-model-point indices (clouds cast to contiguous float32);
    ``distance_impl`` as ``nn_dense``."""
    return nn_dense(scene.to(torch.float32).contiguous(),
                    model.to(torch.float32).contiguous(), distance_impl=distance_impl)


def closest_points_and_targets_dense(scene: torch.Tensor, model: torch.Tensor):
    """K11: ((N,) int32 nearest-model indices, (N, 3) float32 ``model[idx]``)
    (clouds cast to contiguous float32), the indices K1's; on the card one
    launch, whose epilogue copies each winner's row."""
    scene = scene.to(torch.float32).contiguous()
    model = model.to(torch.float32).contiguous()
    _check_pair("closest_points_and_targets_dense", scene, model)
    if scene.device.type == "cpu":
        return nn_dense_points_plain(scene, model)
    n = scene.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=scene.device)
    y = torch.empty((n, 3), dtype=torch.float32, device=scene.device)
    if n:
        keys = torch.empty(n, dtype=torch.int64, device=scene.device)  # (d2, index)
        code = _build.lib().nn_dense_points_launch(
            scene.data_ptr(), n, model.data_ptr(), model.shape[0], keys.data_ptr(),
            idx.data_ptr(), y.data_ptr(), _build.stream_ptr(scene))
        _build.LAUNCHES["nn_dense_points"] += 1
        _build.check(code, "nn_dense_points")
    return idx, y


def nn_dense_points_plain(scene: torch.Tensor, model: torch.Tensor):
    """Plain version of K11: ``nn_dense_plain``'s index and ``model[idx]``
    (a row with no finite distance: index 0, so ``model[0]``)."""
    idx = nn_dense_plain(scene, model)
    return idx, model[idx.long()]
