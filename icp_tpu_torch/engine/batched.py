"""Batched registration: many cloud pairs in one call (port of
``icp_tpu/engine/batched.py``).

JAX runs ``jax.vmap`` over the pair axis, and Pallas batches each
``pallas_call`` under it by a grid axis: one launch an iteration serves all
B pairs.  Here every tensor of the batched paths carries a leading pair
axis and the kernels take it in their grids, so an iteration launches the
same ops and kernels for B pairs as for one, with no Python loop over the
pairs and no host read inside the loop:

  * ``nn_method="pallas"``, ``solver="qcp_fused"``, unmasked and untrimmed
    with models of at most ``MAX_FUSED_MODEL`` rows (``MAX_FUSED_MODEL_CUDA``
    on the card): one launch of K3 an
    iteration (``kernels/icp_fused.py``), each pair's state, loop control
    and error buffer its own;
  * the same bucket-padded (``scene_ns``), trimmed or with larger models:
    one launch of K1 (``nn_dense_batched``), the gather, the weighted
    float64 Horn sums with the pair axis and one launch of K2 (``qcp_step``
    on (B, 1, 18) partials), then the apply;
  * ``bcast``, ``matmul``, ``pallas`` (K1, one launch) or ``bf16`` (K9,
    one launch; each pair centred on its own model mean, computed once a
    call) NN with the ``eigh``, ``qcp``, ``kabsch`` or ``qcp_fused`` solver
    (K5, one launch of ``qcp_rotation_from`` on (B, 3, 3) statistics): one
    NN pass, one gather, batched Horn sums and batched solves.

Only ``grid`` (K1, K4, K2) runs pair by pair through ``icp_fixed_iters``:
JAX has no batched grid path (its ``icp_batched(nn_method="grid")``
raises "unknown nn method: grid"), so the loop is a known difference of
the port, not a missing kernel form.

Semantics, as JAX's: every pair runs exactly ``n_iters`` iterations (a
converged pair keeps re-solving a fixed point).  ``scene_ns`` /
``model_ns`` give each pair's true row counts for bucket-padded inputs
(``batch_pairs``): the pad rows are replica-filled and weigh 0 in every
sum, trim quantile and error mean, as in the single-pair engines.  On the
kernel paths each pair's loop control counts its iterations and its error
buffer keeps its trace; ``err`` is each pair's last error.

Unlike JAX's (ROADMAP R2, R3): ``batch_pairs([])`` raises a ``ValueError``,
and ``solver``/``nn_method`` take ``"auto"``, resolved as ``ICPConfig``
resolves it for the device and the largest true count of the batch.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from icp_tpu_torch.config import ICPConfig
from icp_tpu_torch.engine.icp import ICPResult, as_points, icp_fixed_iters
from icp_tpu_torch.kernels.icp_fused import (
    fused_icp_step,
    fused_path_available,
    prepare_fused_inputs,
)
from icp_tpu_torch.kernels.nn_bf16 import bf16_centres, nearest_indices_bf16_batched
from icp_tpu_torch.kernels.nn_dense import nn_dense_batched
from icp_tpu_torch.kernels.qcp import (
    identity_state,
    new_err_buffer,
    new_loop_control,
    pack_stats,
    qcp_step,
    unpack_states,
)
from icp_tpu_torch.ops.alignment import (
    Similarity,
    alignment_from_stats,
    compute_alignment_stats,
)
from icp_tpu_torch.ops.padding import auto_quantum, bucket_size, pad_to_bucket
from icp_tpu_torch.ops.quantile import histogram_quantile_rows
from icp_tpu_torch.ops.transform import apply_similarity, compose
from icp_tpu_torch.utils.precision import in_full_float32

_BLOCK_ELEMS = 1 << 24  # distance elements of one block of the batched NN
_BATCHED_SOLVERS = ("eigh", "qcp", "kabsch", "qcp_fused")
_BATCHED_NN = ("bcast", "matmul", "pallas", "bf16")


def _counts(ns, batch: int, device) -> torch.Tensor | None:
    """(B,) int64 true counts, or None."""
    if ns is None:
        return None
    return torch.as_tensor(np.asarray(ns), device=device).to(torch.int64).reshape(batch)


def _replica_fill(clouds: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Each pair's rows at and past its count become copies of its last
    real row (``ops/padding.replica_fill`` with a pair axis)."""
    last = torch.gather(clouds, 1, (n - 1)[:, None, None].expand(-1, 1, 3))
    keep = torch.arange(clouds.shape[1], device=clouds.device)[None, :] < n[:, None]
    return torch.where(keep[..., None], clouds, last)


def closest_point_indices_batched(scenes: torch.Tensor, models: torch.Tensor,
                                  method: str, centres: torch.Tensor | None = None
                                  ) -> torch.Tensor:
    """(B, N) int64 nearest model rows of every scene row, each pair into
    its own model: ``"pallas"`` is one launch of K1 for all the pairs
    (``nn_dense_batched``); ``"bf16"`` one launch of K9 on the clouds
    centred on each pair's model mean (``centres``, else computed here:
    ``nearest_indices_bf16_batched``), APPROXIMATE as the single-pair
    ``"bf16"``; ``"bcast"`` (diff-squares) and ``"matmul"`` (``|m|^2 - 2
    s.m``) are ``ops/distance.py``'s forms with a pair axis, in scene
    blocks of at most ``_BLOCK_ELEMS`` distances (lowest index on ties)."""
    if method == "pallas":
        return nn_dense_batched(scenes.contiguous(), models.contiguous()).to(torch.int64)
    if method == "bf16":
        return nearest_indices_bf16_batched(scenes, models, centres).to(torch.int64)
    b, n, m = scenes.shape[0], scenes.shape[1], models.shape[1]
    rows = max(1, _BLOCK_ELEMS // max(b * m, 1))
    if method == "matmul":
        m2 = (models * models).sum(-1)[:, None, :]
        return torch.cat([
            torch.argmin(m2 - 2.0 * (scenes[:, lo:lo + rows] @ models.transpose(-1, -2)), dim=2)
            for lo in range(0, n, rows)], dim=1)
    return torch.cat([
        torch.argmin(((scenes[:, lo:lo + rows, None, :] - models[:, None, :, :]) ** 2).sum(-1),
                     dim=2)
        for lo in range(0, n, rows)], dim=1)


def _trim_weights(p, y, trim_fraction: float, mask):
    """Trimmed-ICP weights of every pair (``engine/icp.trim_weights`` with a
    pair axis): 1 for the ``1 - trim_fraction`` best rows by squared
    distance in K4's order, times the bucket mask."""
    d = y - p
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    tau = histogram_quantile_rows(d2, 1.0 - trim_fraction, mask)
    w = (d2 <= tau[:, None]).to(p.dtype)
    return w if mask is None else w * mask


def _bucket_prologue(models, scenes, s_n, m_n):
    """``engine/icp.bucket_prologue`` with a pair axis: the pad rows of both
    clouds become replicas of each pair's last real row, and the scenes get
    a (B, N) validity mask.  Returns (models, scenes, mask or None)."""
    mask = None
    if s_n is not None:
        scenes = _replica_fill(scenes, s_n)
        mask = (torch.arange(scenes.shape[1], device=scenes.device)[None, :]
                < s_n[:, None]).to(scenes.dtype)
    if m_n is not None:
        models = _replica_fill(models, m_n)
    return models, scenes, mask


def _icp_batched_bcast(models, scenes, *, n_iters: int, solver: str, nn_method: str,
                       with_scale: bool, reference_compat: bool, trim_fraction: float,
                       s_n, m_n) -> ICPResult:
    """The default path: every tensor with the pair axis first; the NN of
    ``closest_point_indices_batched`` (K1 for ``"pallas"``, K9 for
    ``"bf16"``), the solve of ``alignment_from_stats`` (K5 for
    ``"qcp_fused"``)."""
    b, dt, dev = scenes.shape[0], scenes.dtype, scenes.device
    models, scenes, mask = _bucket_prologue(models, scenes, s_n, m_n)
    centres = bf16_centres(models) if nn_method == "bf16" else None  # fixed models: once
    p = scenes
    total = Similarity(s=torch.ones(b, dtype=dt, device=dev),
                       R=torch.eye(3, dtype=dt, device=dev).expand(b, 3, 3),
                       t=torch.zeros((b, 3), dtype=dt, device=dev))
    err = torch.full((b,), math.inf, dtype=dt, device=dev)
    factor = 2.0 if reference_compat else 1.0
    for _ in range(n_iters):
        idx = closest_point_indices_batched(p, models, nn_method, centres)
        y = torch.gather(models, 1, idx[..., None].expand(-1, -1, 3))
        w = _trim_weights(p, y, trim_fraction, mask) if trim_fraction > 0.0 else mask
        stats = compute_alignment_stats(p, y, weights=w)
        sim = alignment_from_stats(stats, solver=solver, with_scale=with_scale)
        p = apply_similarity(p, sim)
        d = y - p
        err_sum = (d * d).sum((-2, -1)) if w is None else (w * (d * d).sum(-1)).sum(-1)
        err = factor * err_sum / stats.n
        total = compose(total, sim)
    iters = torch.full((b,), n_iters, dtype=torch.int32, device=dev)
    return ICPResult(points=p, transform=total, err=err, iters=iters)


def _icp_batched_kernels(models, scenes, *, n_iters: int, with_scale: bool,
                         reference_compat: bool, trim_fraction: float, s_n,
                         m_n) -> ICPResult:
    """``pallas`` + ``qcp_fused``: the single-pair engine's fused and
    pipeline paths (``engine/icp._icp_dense``) with a pair axis.  Each pair
    has its own (32,) state block, (4,) loop control and (n_iters,) error
    buffer; every iteration is one K3 launch (unmasked, untrimmed, models
    within the fused cap), or one K1 launch, the float64
    Horn sums and one K2 launch, for all the pairs.  Fixed mode: only the
    bound raises a pair's done flag, so no iteration needs a host read."""
    b, dt, dev = scenes.shape[0], scenes.dtype, scenes.device
    models, scenes, mask = _bucket_prologue(models, scenes, s_n, m_n)
    state = identity_state(dev, b)
    ctl, errs = new_loop_control(n_iters, dev, b), new_err_buffer(n_iters, dev, b)
    step_kw = dict(with_scale=with_scale, threshold=-math.inf,
                   err_factor=2.0 if reference_compat else 1.0, converge=False, guard=False)
    if fused_path_available("qcp_fused", "pallas", trim_fraction, models,
                            masked=mask is not None):
        prep = prepare_fused_inputs(scenes, models)
        for _ in range(n_iters):
            fused_icp_step(prep, state, ctl, errs, **step_kw)
        total = Similarity(*(v.to(dt) for v in unpack_states(state)[1]))
        p = apply_similarity(scenes, total)
    else:
        p = scenes
        for _ in range(n_iters):
            idx = closest_point_indices_batched(p, models, "pallas")
            y = torch.gather(models, 1, idx[..., None].expand(-1, -1, 3))
            w = _trim_weights(p, y, trim_fraction, mask) if trim_fraction > 0.0 else mask
            stats = compute_alignment_stats(p, y, acc_dtype=torch.float64, weights=w)
            qcp_step(pack_stats(stats), state, ctl, errs, **step_kw)
            p = apply_similarity(p, Similarity(*(v.to(dt) for v in unpack_states(state)[0])))
        total = Similarity(*(v.to(dt) for v in unpack_states(state)[1]))
    iters = ctl[:, 0].clone()
    last = (iters.to(torch.int64) - 1).clamp(min=0)
    err = errs.gather(1, last[:, None])[:, 0] if n_iters else errs.new_full((b,), math.inf)
    err = torch.where(iters > 0, err, math.inf)
    return ICPResult(points=p, transform=total, err=err.to(dt), iters=iters)


@in_full_float32
def icp_batched(models, scenes, *, n_iters: int, solver: str = "eigh",
                nn_method: str = "bcast", with_scale: bool = True,
                reference_compat: bool = True, trim_fraction: float = 0.0,
                scene_ns=None, model_ns=None, device=None) -> ICPResult:
    """Register B pairs, (B, M, 3) models and (B, N, 3) scenes, for exactly
    ``n_iters`` float32 iterations each; every field of the result gains a
    leading pair axis (``points`` (B, N, 3), ``transform`` s (B,), R (B, 3,
    3), t (B, 3), ``err`` and ``iters`` (B,)).  With ``scene_ns`` /
    ``model_ns`` (B,), rows past a pair's count are padding and its
    ``points`` rows there are meaningless: slice per pair.  Devices as in
    ``icp``: numpy input goes to the card unless ``device="cpu"``."""
    models = as_points(models, torch.float32, device)
    scenes = as_points(scenes, torch.float32, models.device)
    if models.dim() != 3 or scenes.dim() != 3 or models.shape[0] != scenes.shape[0]:
        raise ValueError(f"icp_batched: models (B, M, 3) and scenes (B, N, 3), got "
                         f"{tuple(models.shape)} and {tuple(scenes.shape)}")
    b, dev = scenes.shape[0], scenes.device
    s_n, m_n = _counts(scene_ns, b, dev), _counts(model_ns, b, dev)
    cfg = ICPConfig(solver=solver, nn_method=nn_method)
    n_points = max(int(models.shape[1] if m_n is None else m_n.max()),
                   int(scenes.shape[1] if s_n is None else s_n.max()))
    nn_method = cfg.resolved_nn_method(dev.type, n_points)
    solver = cfg.resolved_solver(dev.type)
    kw = dict(with_scale=with_scale, reference_compat=reference_compat,
              trim_fraction=trim_fraction)
    n_iters = max(int(n_iters), 0)  # a negative count runs no iteration
    if nn_method == "pallas" and solver == "qcp_fused":
        return _icp_batched_kernels(models, scenes, n_iters=n_iters, s_n=s_n, m_n=m_n, **kw)
    if nn_method in _BATCHED_NN and solver in _BATCHED_SOLVERS:
        return _icp_batched_bcast(models, scenes, n_iters=n_iters, solver=solver,
                                  nn_method=nn_method, s_n=s_n, m_n=m_n, **kw)
    out = [icp_fixed_iters(models[i], scenes[i], n_iters=n_iters, solver=solver,
                           nn_method=nn_method,
                           scene_n=None if s_n is None else int(s_n[i]),
                           model_n=None if m_n is None else int(m_n[i]), **kw)
           for i in range(b)]
    return ICPResult(points=torch.stack([r.points for r in out]),
                     transform=Similarity(*(torch.stack([getattr(r.transform, f) for r in out])
                                            for f in Similarity._fields)),
                     err=torch.stack([r.err for r in out]),
                     iters=torch.stack([r.iters.reshape(()) for r in out]))


def batch_pairs(pairs: Sequence[Tuple[np.ndarray, np.ndarray]], quantum: int | None = None):
    """Pack unequal-size (model, scene) pairs into one bucketed batch: every
    cloud sentinel-padded (``ops/padding.py``) to the batch-wide largest
    bucket of its role.  Returns ``(models, scenes, model_ns, scene_ns)``,
    float32 and int32 ndarrays, the inputs of ``icp_batched``.
    ``quantum=None``: ``auto_quantum`` of the largest cloud."""
    if not pairs:
        raise ValueError("batch_pairs: no pairs to batch")
    m_max = max(len(m) for m, _ in pairs)
    s_max = max(len(s) for _, s in pairs)
    if quantum is None:
        quantum = auto_quantum(max(m_max, s_max))
    m_pad, s_pad = bucket_size(m_max, quantum), bucket_size(s_max, quantum)
    models, scenes, m_ns, s_ns = [], [], [], []
    for m, s in pairs:
        mp, mn = pad_to_bucket(np.asarray(m, np.float32), n_pad=m_pad)
        sp, sn = pad_to_bucket(np.asarray(s, np.float32), n_pad=s_pad)
        models.append(mp)
        scenes.append(sp)
        m_ns.append(mn)
        s_ns.append(sn)
    return (np.stack(models), np.stack(scenes), np.asarray(m_ns, np.int32),
            np.asarray(s_ns, np.int32))


def register_chain_batched(clouds: Sequence[np.ndarray], *, n_iters: int,
                           quantum: int | None = None, solver: str = "eigh",
                           nn_method: str = "bcast", with_scale: bool = True,
                           trim_fraction: float = 0.0, device=None) -> List[ICPResult]:
    """The whole scan chain as one batch: pair b registers ``clouds[b+1]``
    onto ``clouds[b]`` (``slam.register_chain``'s orientation), unequal
    counts bucketed, fixed iterations (``icp_batched``).  One ``ICPResult``
    a pair, ``points`` sliced back to the true scene size."""
    pairs = [(clouds[i], clouds[i + 1]) for i in range(len(clouds) - 1)]
    models, scenes, m_ns, s_ns = batch_pairs(pairs, quantum)
    out = icp_batched(models, scenes, n_iters=n_iters, solver=solver, nn_method=nn_method,
                      with_scale=with_scale, reference_compat=True,
                      trim_fraction=trim_fraction, scene_ns=s_ns, model_ns=m_ns,
                      device=device)
    return [ICPResult(points=out.points[b, :int(s_ns[b])],
                      transform=Similarity(*(v[b] for v in out.transform)),
                      err=out.err[b], iters=out.iters[b])
            for b in range(len(pairs))]
