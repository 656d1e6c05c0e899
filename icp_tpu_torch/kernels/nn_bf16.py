"""K9: bf16-prefiltered nearest neighbour with an exact recheck and a margin
certificate (``csrc/nn_bf16.cu``).

Port of ``icp_tpu/kernels/nn_bf16.py`` (``_nn_bf16_kernel`` via
``closest_point_indices_bf16``).  The approximate distance is
``d~ = |m|^2 - 2 fl16(p) . fl16(m)``: the norm in exact float32, only the
cross term from bf16-rounded coordinates.  For every scene point the kernel
gives the argmin of ``d~`` (lowest index on ties), the least and the second
least ``d~`` (the second counted with multiplicity) and the exact float32
distance to the winner.  ``second - best > 2B`` with ``B`` the rigorous
cross-term bound (``cross_term_bound``) proves the argmin is the exact
nearest neighbour; elsewhere the index may be any candidate within the
``2B`` band, which is why no engine takes this path unless asked
(``nn_method="bf16"``).  The promises, whatever the flips:

  * the reported distance is exact for the reported index;
  * it bounds the true nearest-neighbour distance from above;
  * a certified index is the exact nearest neighbour.

``nn_bf16_plain`` is the same function in plain torch, with the cross term
rounded as ``(x + y) + z`` by round-to-nearest adds; the wrapper takes it
only for CPU tensors.  The kernel forms the cross term on the tensor cores,
whose float32 accumulation of the three exact bf16 products need not round
so: its ``best`` and ``second`` may differ from the plain version's by an
ulp of the cross term (``cross_term_slack``), and its index where two
candidates are that close.  The promises above hold either way.  The JAX
kernel's tile sizes do not change the function, and the entry point
accepts and ignores them.

``nn_bf16_batched`` is K9 with a pair axis, the counterpart of JAX's
``vmap`` over the ``pallas_call`` (``icp_batched(nn_method="bf16")``): B
pairs of (N, 3) scenes and (M, 3) models in one launch, the indices
pair-local, each pair's quadruple bit-equal to ``nn_bf16`` on that pair
alone (the kernels' result does not depend on their chunking); ``nn_bf16``
is its B = 1 case, and ``nn_bf16_batched_plain`` is ``nn_bf16_plain`` pair
by pair.  ``nearest_indices_bf16_batched`` centres each pair on its own
model mean, computed by the single-pair reduction (``bf16_centres``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from icp_tpu_torch.kernels import _build
from icp_tpu_torch.kernels.nn_dense import _check_batch, check_points

_PLAIN_BLOCK_ELEMS = 1 << 24  # distance elements per block of the plain version
_BF16_U = 2.0 ** -8
# 16u > the derived 12.06u (icp_tpu/kernels/nn_bf16.py:29-34): the slack
# also covers a tensor-core product's non-IEEE float32 accumulation.
_BF16_BOUND_FACTOR = 16.0 * _BF16_U


def cross_term_bound(scene: torch.Tensor, model: torch.Tensor) -> torch.Tensor:
    """Rigorous float32 bound on ``|d~ - d|`` from the bf16 rounding of the
    cross term: ``16 u * max|p| * max|m|``."""
    pmax = scene.to(torch.float32).abs().amax()
    mmax = model.to(torch.float32).abs().amax()
    return pmax * _BF16_BOUND_FACTOR * mmax  # the factor is a power of 2: exact


def cross_term_slack(scene: torch.Tensor, model: torch.Tensor) -> torch.Tensor:
    """``3 * 2^-20 * max|p| * max|m|``: the most by which the kernel's
    ``best`` or ``second`` may differ from the plain version's, a few ulp
    of the doubled cross term (``|2 p.m| <= 6 max|p| max|m|``); about
    21,800x below the certificate's ``B``."""
    pmax = scene.to(torch.float32).abs().amax()
    mmax = model.to(torch.float32).abs().amax()
    return pmax * (3.0 * 2.0 ** -20) * mmax


@functools.lru_cache(maxsize=64)
def plan(n: int, m: int, device_index: int = 0, pairs: int = 1):
    """(model chunks, rows a chunk, scratch bytes) of a launch of ``pairs``
    (n, m) pairs on card ``device_index`` (the C launcher's choice: about
    one wave over all the pairs' scene blocks); kept per shape, so a loop
    asks the library once."""
    out = [ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()]
    _build.check(_build.lib().nn_bf16_batched_plan(pairs, n, m,
                                                   *(ctypes.addressof(v) for v in out)),
                 "nn_bf16")
    return tuple(v.value for v in out)


def _launch(scene: torch.Tensor, model: torch.Tensor, pairs: int):
    """One launch of K9 on ``pairs`` (n, 3) scenes and (m, 3) models laid
    out one after another: four (scene.shape[:-1]) outputs."""
    n, m = scene.shape[-2], model.shape[-2]
    dev, shape = scene.device, scene.shape[:-1]
    idx = torch.empty(shape, dtype=torch.int32, device=dev)
    best, second, dex = (torch.empty(shape, dtype=torch.float32, device=dev) for _ in range(3))
    if n and pairs:
        scratch = torch.empty(plan(n, m, dev.index, pairs)[2] // 4, dtype=torch.int32, device=dev)
        code = _build.lib().nn_bf16_batched_launch(
            scene.data_ptr(), pairs, n, model.data_ptr(), m, scratch.data_ptr(), idx.data_ptr(),
            best.data_ptr(), second.data_ptr(), dex.data_ptr(), _build.stream_ptr(scene))
        _build.LAUNCHES["nn_bf16"] += 1
        _build.check(code, "nn_bf16")
    return idx, best, second, dex


def nn_bf16(scene: torch.Tensor, model: torch.Tensor):
    """K9: (idx (N,) int32, best (N,) float32, second (N,) float32,
    d_exact (N,) float32) for float32 (N, 3) and (M, 3) clouds."""
    check_points("nn_bf16", "scene", scene)
    check_points("nn_bf16", "model", model, scene.device)
    if model.shape[0] < 1:
        raise ValueError("nn_bf16: empty model")
    if scene.device.type == "cpu":
        return nn_bf16_plain(scene, model)
    return _launch(scene, model, 1)


def nn_bf16_batched(scenes: torch.Tensor, models: torch.Tensor):
    """K9 with a pair axis: (idx, best, second, d_exact), each (B, N), for
    contiguous float32 ``scenes`` (B, N, 3) and ``models`` (B, M, 3), every
    pair into its own model (pair-local indices).  On the card one launch
    for all the pairs, each pair's output ``nn_bf16``'s on that pair."""
    _check_batch("nn_bf16_batched", scenes, models)
    if scenes.device.type == "cpu":
        return nn_bf16_batched_plain(scenes, models)
    return _launch(scenes, models, scenes.shape[0])


def nn_bf16_batched_plain(scenes: torch.Tensor, models: torch.Tensor):
    """Plain version of ``nn_bf16_batched``: ``nn_bf16_plain`` pair by
    pair."""
    shape, dev = scenes.shape[:-1], scenes.device
    outs = (torch.empty(shape, dtype=torch.int32, device=dev),
            *(torch.empty(shape, dtype=torch.float32, device=dev) for _ in range(3)))
    for b, (s, m) in enumerate(zip(scenes, models)):
        for out, one in zip(outs, nn_bf16_plain(s, m)):
            out[b] = one
    return outs


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def nn_bf16_plain(scene: torch.Tensor, model: torch.Tensor):
    """Plain version of K9: ``d~`` with the kernel's roundings, the first
    index of its minimum, the minimum of the rest as the second, and the
    diff-squares distance to the winner."""
    n, m = scene.shape[0], model.shape[0]
    pb, mb = _bf16(scene), _bf16(model)
    norm = (model[:, 0] * model[:, 0] + model[:, 1] * model[:, 1]) + model[:, 2] * model[:, 2]
    rows = max(1, _PLAIN_BLOCK_ELEMS // m)
    dev = scene.device
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    best, second = (torch.empty(n, dtype=torch.float32, device=dev) for _ in range(2))
    for lo in range(0, n, rows):
        p = pb[lo:lo + rows]
        cross = (p[:, None, 0] * mb[None, :, 0] + p[:, None, 1] * mb[None, :, 1]) \
            + p[:, None, 2] * mb[None, :, 2]
        d = norm[None, :] - 2.0 * cross
        b, arg = torch.min(d, dim=1)  # first index of the minimum
        d.scatter_(1, arg[:, None], float("inf"))
        idx[lo:lo + rows] = arg.to(torch.int32)
        best[lo:lo + rows] = b
        second[lo:lo + rows] = d.amin(1)
    diff = scene - model[idx.to(torch.int64)]
    dex = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]) + diff[:, 2] * diff[:, 2]
    return idx, best, second, dex


def closest_point_indices_bf16(scene: torch.Tensor, model: torch.Tensor, *,
                               scene_tile: int = 256, model_tile: int = 4096,
                               center: bool = True):
    """Approximate NN by the bf16 prefilter with an exact recheck:
    ``(idx (N,) int32, d_exact (N,) float32, certified (N,) bool)``.

    ``center=True`` subtracts the float32 model mean from both clouds first
    (distance-preserving up to the float32 rounding of the shift), which
    shrinks the bound from the clouds' offset to their spread.  The tile
    arguments are the JAX kernel's and are ignored."""
    del scene_tile, model_tile
    scene, model = _float32_clouds(scene, model, center)
    bound = cross_term_bound(scene, model)
    idx, best, second, dex = nn_bf16(scene, model)
    return idx, dex, (second - best) > 2.0 * bound


def nearest_indices_bf16(scene: torch.Tensor, model: torch.Tensor) -> torch.Tensor:
    """The indices of ``closest_point_indices_bf16`` (centred) alone: no
    bound, no certificate, for the engines' per-iteration search."""
    return nn_bf16(*_float32_clouds(scene, model, True))[0]


def bf16_centres(models: torch.Tensor) -> torch.Tensor:
    """(B, 3) float32: each pair's model mean, by the reduction the
    single-pair path takes on its (M, 3) model (``_float32_clouds``), so
    a pair is centred bit for bit as it is alone (``models.mean(1)`` is
    another reduction over (B, M, 3) and may differ in the last bit, which
    moves K9's argmin inside its band)."""
    models = models.to(torch.float32)
    centres = models.new_empty((models.shape[0], 3))
    for b, m in enumerate(models):
        centres[b] = m.clone().mean(0)
    return centres


def nearest_indices_bf16_batched(scenes: torch.Tensor, models: torch.Tensor,
                                 centres: torch.Tensor | None = None) -> torch.Tensor:
    """``nearest_indices_bf16`` with a pair axis: (B, N) int32, one launch
    of K9.  ``centres``: ``bf16_centres(models)``, which a loop over fixed
    models computes once."""
    c = (bf16_centres(models) if centres is None else centres)[:, None, :]
    scenes, models = scenes.to(torch.float32), models.to(torch.float32)
    return nn_bf16_batched((scenes - c).contiguous(), (models - c).contiguous())[0]


def _float32_clouds(scene: torch.Tensor, model: torch.Tensor, center: bool):
    scene = scene.to(torch.float32)
    model = model.to(torch.float32)
    if center:
        c = model.mean(0)
        scene = scene - c
        model = model - c
    return scene.contiguous(), model.contiguous()
