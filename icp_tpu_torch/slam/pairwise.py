"""Multi-scan pairwise registration chains (port of
``icp_tpu/slam/pairwise.py``).

Registers each scan onto its predecessor with unequal point counts (the
five Stanford bunny views, 31,701-40,256 points), optionally from a global
start (principal axes, or FPFH + RANSAC), coarse to fine, and composes the
pairwise transforms into world poses: the front end of the pose graph
(``slam/pose_graph.py``).  Every pair goes through ``engine.plane
.run_engine``, so all four engines and their kernel paths serve the chain.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from icp_tpu_torch.config import ICPConfig
from icp_tpu_torch.engine.icp import target_device
from icp_tpu_torch.engine.plane import run_engine
from icp_tpu_torch.ops.alignment import Similarity
from icp_tpu_torch.ops.padding import bucket_size, pad_to_bucket, resolve_auto_bucket
from icp_tpu_torch.ops.transform import cast_similarity, compose, identity_similarity


@dataclasses.dataclass
class PairwiseResult:
    """Scan i registered onto scan i-1 (or a given target)."""

    transform: Similarity  # maps the source scan into the target frame
    err: float
    iters: int


def initialize_pca(model: np.ndarray, scene: np.ndarray, *, with_scale: bool = False,
                   subsample: int = 8) -> Similarity:
    """Global start by principal-axis alignment, on the host in float64
    numpy (a copy of the JAX function): R = U_m D U_s^T over the four proper
    sign flips D, scored by the mean nearest-neighbour residual on
    subsampled clouds (at most 4,096 rows each); t = mu_m - s R mu_s.
    Returns float32 CPU tensors; the engines move them to their device."""
    m_sub = np.asarray(model[::subsample], np.float32)
    s_sub = np.asarray(scene[::subsample], np.float32)
    while m_sub.shape[0] > 4096 or s_sub.shape[0] > 4096:
        m_sub, s_sub = m_sub[::2], s_sub[::2]
    mu_m = np.asarray(model, np.float64)[::subsample].mean(0)
    mu_s = np.asarray(scene, np.float64)[::subsample].mean(0)
    Cm = np.cov((np.asarray(model[::subsample], np.float64) - mu_m).T)
    Cs = np.cov((np.asarray(scene[::subsample], np.float64) - mu_s).T)
    wm, Um = np.linalg.eigh(Cm)
    ws, Us = np.linalg.eigh(Cs)
    if np.linalg.det(Um) < 0:
        Um[:, 0] = -Um[:, 0]
    if np.linalg.det(Us) < 0:
        Us[:, 0] = -Us[:, 0]
    s = float(np.sqrt(np.sum(wm) / np.sum(ws))) if with_scale else 1.0
    m2 = np.sum(m_sub.astype(np.float64) ** 2, axis=1)
    best = None
    for signs in ((1, 1, 1), (1, -1, -1), (-1, 1, -1), (-1, -1, 1)):
        R = Um @ np.diag(signs) @ Us.T  # proper rotation (det = +1)
        t = mu_m - s * R @ mu_s
        moved = s_sub.astype(np.float64) @ (s * R).T + t
        d2 = (np.sum(moved * moved, axis=1)[:, None] + m2[None, :]
              - 2.0 * moved @ m_sub.astype(np.float64).T)
        resid = float(np.mean(np.maximum(d2.min(axis=1), 0.0)))
        if best is None or resid < best[0]:
            best = (resid, (s, R, t))
    s, R, t = best[1]
    return cast_similarity(Similarity(s, R, t), torch.float32)


def register_pair(model: np.ndarray, scene: np.ndarray, config: Optional[ICPConfig] = None, *,
                  multiscale: Sequence[int] = (1,), init: Optional[object] = None,
                  engine: str = "point_to_point", bucket_quantum: Optional[int] = None,
                  pad_sizes: Optional[Sequence[int]] = None, device=None) -> PairwiseResult:
    """Register ``scene`` onto ``model`` (unequal counts allowed).

    ``multiscale``: subsampling factors, coarse to fine (e.g. ``(16, 4,
    1)``), each level warm-started from the last.  ``bucket_quantum`` /
    ``pad_sizes``: pad each level's clouds to a bucket (or the given size)
    and pass the true counts (``ops/padding.py``).  ``init``: a
    ``Similarity``, ``"pca"`` (``initialize_pca``) or ``"fpfh"``
    (``engine/global_reg.global_register``).  ``engine``: one of
    ``run_engine``'s names; the plane engines are rigid.  Devices as in
    ``icp``: the card unless ``device="cpu"``."""
    cfg = config or ICPConfig()
    if cfg.validate_inputs:
        cfg = dataclasses.replace(cfg, validate_inputs=False)
    if engine != "point_to_point" and cfg.with_scale:
        cfg = dataclasses.replace(cfg, with_scale=False)  # plane metrics are SE(3)
    if isinstance(init, str) and init == "pca":
        init = initialize_pca(model, scene, with_scale=cfg.with_scale)
    elif isinstance(init, str) and init == "fpfh":
        from icp_tpu_torch.engine.global_reg import global_register

        init = global_register(model, scene, with_scale=cfg.with_scale, device=device).transform
    total = identity_similarity(cfg.dtype) if init is None else init
    err, iters = float("inf"), 0
    for lvl, k in enumerate(multiscale):
        sub_model = np.ascontiguousarray(model[::k])
        sub_scene = np.ascontiguousarray(scene[::k])
        kw = {}
        if bucket_quantum or pad_sizes is not None:
            n_pad = None if pad_sizes is None else int(pad_sizes[lvl])
            sub_model, m_n = pad_to_bucket(sub_model, bucket_quantum or 4096, n_pad=n_pad)
            sub_scene, s_n = pad_to_bucket(sub_scene, bucket_quantum or 4096, n_pad=n_pad)
            kw = dict(model_n=m_n, scene_n=s_n)
        res = run_engine(engine, sub_model, sub_scene, cfg, init=total, device=device, **kw)
        total = res.transform
        err, iters = float(res.err), iters + int(res.iters)
    return PairwiseResult(transform=total, err=err, iters=iters)


def register_chain(clouds: Sequence[np.ndarray], config: Optional[ICPConfig] = None, *,
                   multiscale: Sequence[int] = (1,), init: Optional[object] = None,
                   engine: str = "point_to_point", bucket_quantum="auto",
                   device=None) -> List[PairwiseResult]:
    """Register each scan onto its predecessor: ``results[i]`` maps cloud
    i+1 into cloud i's frame.  ``bucket_quantum="auto"`` pads every pair
    of an unequal-count chain to the chain-wide largest bucket of each
    level on the CPU, none on the card (``resolve_auto_bucket``), None
    turns it off, an int sets the quantum."""
    if bucket_quantum == "auto":
        bucket_quantum = resolve_auto_bucket(clouds, target_device(None, device))
    pad_sizes = None
    if bucket_quantum:
        pad_sizes = [bucket_size(max(len(c[::k]) for c in clouds), bucket_quantum)
                     for k in multiscale]
    return [register_pair(a, b, config, multiscale=multiscale, init=init, engine=engine,
                          bucket_quantum=bucket_quantum, pad_sizes=pad_sizes, device=device)
            for a, b in zip(clouds[:-1], clouds[1:])]


def chain_to_world_poses(pairs: Sequence[PairwiseResult]) -> List[Similarity]:
    """World poses (the frame of scan 0) from the chain: ``pose[i]`` maps
    scan i into scan 0; ``pose[0]`` is the identity."""
    like = pairs[0].transform.R if pairs else torch.eye(3)
    poses = [identity_similarity(like.dtype, like.device)]
    for pr in pairs:
        poses.append(compose(pr.transform, poses[-1]))
    return poses
