"""Batched registration: many cloud pairs in one call (port of
``icp_tpu/engine/batched.py``).

JAX runs ``jax.vmap`` over the pair axis.  Here the default path (the
``bcast`` NN with the ``eigh``, ``qcp`` or ``kabsch`` solver) is written
with a leading pair axis on every tensor: one blocked (B, rows, M)
distance pass, one gather, batched Horn sums and batched solves, so an
iteration launches the same ops for B pairs as for one and there is no
Python loop over the pairs inside it.  The kernel paths run pair by pair
through ``icp_fixed_iters`` (the counterpart of ``vmap`` over a
``pallas_call`` is a pair axis in the kernels, not written yet):
``nn_method="pallas"`` takes K3 for an unmasked pair with
``solver="qcp_fused"`` and K1 + K2 otherwise, ``"grid"`` takes K1, K4 and
K2, and ``qcp_fused`` with the ``bcast`` NN takes K5.

Semantics, as JAX's: every pair runs exactly ``n_iters`` iterations (a
converged pair keeps re-solving a fixed point).  ``scene_ns`` /
``model_ns`` give each pair's true row counts for bucket-padded inputs
(``batch_pairs``): the pad rows are replica-filled and weigh 0 in every
sum, trim quantile and error mean, as in the single-pair engines.

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
_BATCHED_SOLVERS = ("eigh", "qcp", "kabsch")


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


def closest_point_indices_batched(scenes: torch.Tensor, models: torch.Tensor) -> torch.Tensor:
    """(B, N) int64 nearest model rows of every scene row, pair by pair: the
    ``bcast`` NN (diff-squares distance, lowest index on ties) with a pair
    axis, in scene blocks of at most ``_BLOCK_ELEMS`` distances."""
    b, n, m = scenes.shape[0], scenes.shape[1], models.shape[1]
    rows = max(1, _BLOCK_ELEMS // max(b * m, 1))
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


def _icp_batched_bcast(models, scenes, *, n_iters: int, solver: str, with_scale: bool,
                       reference_compat: bool, trim_fraction: float, s_n, m_n) -> ICPResult:
    """The default path: every tensor with the pair axis first."""
    b, n, dt, dev = scenes.shape[0], scenes.shape[1], scenes.dtype, scenes.device
    mask = None
    if s_n is not None:
        scenes = _replica_fill(scenes, s_n)
        mask = (torch.arange(n, device=dev)[None, :] < s_n[:, None]).to(dt)
    if m_n is not None:
        models = _replica_fill(models, m_n)
    p = scenes
    total = Similarity(s=torch.ones(b, dtype=dt, device=dev),
                       R=torch.eye(3, dtype=dt, device=dev).expand(b, 3, 3),
                       t=torch.zeros((b, 3), dtype=dt, device=dev))
    err = torch.full((b,), math.inf, dtype=dt, device=dev)
    factor = 2.0 if reference_compat else 1.0
    for _ in range(n_iters):
        idx = closest_point_indices_batched(p, models)
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
    if nn_method == "bcast" and solver in _BATCHED_SOLVERS:
        return _icp_batched_bcast(models, scenes, n_iters=n_iters, solver=solver,
                                  s_n=s_n, m_n=m_n, **kw)
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
