"""Loop-closure detection and verification (port of
``icp_tpu/slam/closure.py``).

Every candidate pair of non-adjacent scans is scored by the global
registration pipeline (FPFH, spectral consistency, RANSAC:
``engine/global_reg.py``); pairs whose inlier fraction clears a threshold
are closures, refined by ICP (``refine_closures``) into pose-graph edges.
Each scan is subsampled to one shared count with numpy's
``default_rng(seed)`` (``_subsample_fixed``), so both packages pick the
same rows.  JAX vmaps the pairs in chunks for its compile cache; the port
scores them one after another on the device, with one host read of the
fraction a pair, and its RANSAC draws from one ``torch.Generator`` seeded
with ``seed``, pair after pair.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from icp_tpu_torch.ops.alignment import Similarity


class ClosureCandidate(NamedTuple):
    """A detected loop closure: scan ``j`` registered into scan ``i``'s frame
    (as ``register_pair(model=clouds[i], scene=clouds[j])`` and
    ``PoseEdge(i, j, ...)``)."""

    i: int
    j: int
    transform: Similarity
    inlier_fraction: float
    n_mutual: int


def _subsample_fixed(cloud: np.ndarray, n_out: int, rng: np.random.Generator) -> np.ndarray:
    """Exactly ``n_out`` distinct rows (uniform without replacement)."""
    n = cloud.shape[0]
    if n <= n_out:
        return np.ascontiguousarray(cloud)
    sel = rng.choice(n, n_out, replace=False)
    sel.sort()
    return np.ascontiguousarray(cloud[sel])


def detect_loop_closures(clouds: Sequence[np.ndarray], *, min_separation: int = 2,
                         candidate_pairs: Optional[Sequence[Tuple[int, int]]] = None,
                         max_points: int = 2048, k: int = 32, voxel: Optional[float] = None,
                         inlier_min: float = 0.15, n_hypotheses: int = 512,
                         with_scale: bool = False, seed: int = 0,
                         device=None) -> List[ClosureCandidate]:
    """Overlapping non-adjacent scan pairs and their coarse poses, best
    first.  ``candidate_pairs`` defaults to every (i, j) with ``j - i >=
    min_separation``; a pair is a closure when its RANSAC inlier fraction
    is at least ``inlier_min``.  Devices as in ``icp``: the card unless
    ``device="cpu"``."""
    from icp_tpu_torch.engine.global_reg import median_spacing, register_features
    from icp_tpu_torch.engine.icp import as_points
    from icp_tpu_torch.ops.fpfh import fpfh_features
    from icp_tpu_torch.ops.voxel import voxel_downsample_np

    n_scans = len(clouds)
    if candidate_pairs is None:
        candidate_pairs = [(i, j) for i in range(n_scans)
                           for j in range(i + min_separation, n_scans)]
    candidate_pairs = list(candidate_pairs)
    if not candidate_pairs:
        return []
    rng = np.random.default_rng(seed)
    subs = []
    for c in clouds:
        c_np = np.asarray(c, np.float32)
        if voxel is not None:
            c_np, _ = voxel_downsample_np(c_np, voxel, device=device)
        subs.append(c_np)
    size = min(max_points, min(s.shape[0] for s in subs))  # one shared size
    pts = [as_points(_subsample_fixed(s, size, rng), torch.float32, device) for s in subs]
    taus = [3.0 * median_spacing(p).clamp(min=1e-12) for p in pts]
    feats = [fpfh_features(p, k=k) for p in pts]
    g = torch.Generator(device=pts[0].device).manual_seed(seed)
    results: List[ClosureCandidate] = []
    for i, j in candidate_pairs:
        sim, frac, mutual = register_features(pts[i], pts[j], feats[i], feats[j], taus[i],
                                              generator=g, n_hypotheses=n_hypotheses,
                                              with_scale=with_scale)
        if float(frac) >= inlier_min:
            results.append(ClosureCandidate(i=i, j=j, transform=sim,
                                            inlier_fraction=float(frac),
                                            n_mutual=int(mutual)))
    results.sort(key=lambda c: -c.inlier_fraction)
    return results


def _tau(m: torch.Tensor, tau_factor: float) -> torch.Tensor:
    from icp_tpu_torch.engine.global_reg import median_spacing

    return tau_factor * median_spacing(m)


def overlap_fraction(model: np.ndarray, scene: np.ndarray, transform: Similarity, *,
                     tau_factor: float = 3.0, max_points: int = 2048, seed: int = 0,
                     nn_method: str = "auto", device=None) -> float:
    """Fraction of ``scene`` points within tau of a ``model`` point after
    ``transform`` (tau = ``tau_factor`` x the model's median nearest-
    neighbour spacing): an overlap-extent estimate for a pose known to be
    right, not a verifier (``verified_inlier_fraction`` is)."""
    from icp_tpu_torch.engine.icp import as_points
    from icp_tpu_torch.ops.distance import closest_point_indices
    from icp_tpu_torch.ops.transform import apply_similarity, cast_similarity

    rng = np.random.default_rng(seed)
    m = as_points(_subsample_fixed(np.asarray(model, np.float32), max_points, rng),
                  torch.float32, device)
    s = as_points(_subsample_fixed(np.asarray(scene, np.float32), max_points, rng),
                  torch.float32, m.device)
    moved = apply_similarity(s, cast_similarity(transform, torch.float32, m.device))
    tau = _tau(m, tau_factor)
    idx = closest_point_indices(moved, m, method=nn_method).long()
    d2 = ((moved - m[idx]) ** 2).sum(1)
    return float((d2 <= tau * tau).to(torch.float32).mean())


def verified_inlier_fraction(model: np.ndarray, scene: np.ndarray, transform: Similarity, *,
                             tau_factor: float = 3.0, max_points: int = 2048, k: int = 32,
                             seed: int = 0, device=None) -> float:
    """Feature-verified confidence of a registration: the fraction of mutual
    FPFH matches that ``transform`` puts within tau (``tau_factor`` x the
    model's median nearest-neighbour spacing) of each other."""
    from icp_tpu_torch.engine.global_reg import match_features
    from icp_tpu_torch.engine.icp import as_points
    from icp_tpu_torch.ops.fpfh import fpfh_features
    from icp_tpu_torch.ops.transform import apply_similarity, cast_similarity

    rng = np.random.default_rng(seed)
    size = min(max_points, np.asarray(model).shape[0], np.asarray(scene).shape[0])
    m = as_points(_subsample_fixed(np.asarray(model, np.float32), size, rng),
                  torch.float32, device)
    s = as_points(_subsample_fixed(np.asarray(scene, np.float32), size, rng),
                  torch.float32, m.device)
    tau = _tau(m, tau_factor)
    idx, valid = match_features(fpfh_features(m, k=min(k, size - 1)),
                                fpfh_features(s, k=min(k, size - 1)))
    moved = apply_similarity(s, cast_similarity(transform, torch.float32, m.device))
    d2 = ((moved - m[idx]) ** 2).sum(1)
    n_ok = float((valid & (d2 <= tau * tau)).sum())
    return n_ok / max(1.0, float(valid.sum()))


def _edge(i: int, j: int, transform: Similarity, weight: float):
    from icp_tpu_torch.slam.pose_graph import PoseEdge

    return PoseEdge(i, j, transform.R.detach().clone(), transform.t.detach().clone(),
                    weight=weight)


def chain_edges_from_pairs(pairs, clouds: Optional[Sequence[np.ndarray]] = None, *,
                           min_confidence: float = 0.1, outlier_ratio: float = 25.0,
                           min_weight: float = 1e-3, device=None) -> Tuple[list, List[int]]:
    """Pose-graph edges of the odometry chain, weighted by quality: with
    ``clouds``, each edge by its ``verified_inlier_fraction`` (at least
    ``min_weight``); always, an error above ``outlier_ratio`` times the
    chain's lower quartile drops the edge to ``min_weight``.  Returns
    ``(edges, suspect_ks)``, the edges below ``min_confidence``."""
    errs = np.array([float(p.err) for p in pairs], np.float64)
    baseline = max(float(np.quantile(errs, 0.25)), 1e-12)
    edges, suspects = [], []
    for k, pr in enumerate(pairs):
        if errs[k] > outlier_ratio * baseline:
            w = min_weight
        elif clouds is not None:
            w = max(min_weight, verified_inlier_fraction(clouds[k], clouds[k + 1],
                                                         pr.transform, device=device))
        else:
            w = 1.0
        if w < min_confidence:
            suspects.append(k)
        edges.append(_edge(k, k + 1, pr.transform, w))
    return edges, suspects


def refine_closures(clouds: Sequence[np.ndarray], candidates: Sequence[ClosureCandidate],
                    config=None, *, engine: str = "point_to_point",
                    multiscale: Sequence[int] = (1,), max_err: Optional[float] = None,
                    weighted: bool = True, bucket_quantum: Optional[int] = None,
                    pad_sizes=None, device=None):
    """ICP-refine detected closures: ``(edges, results)``, the
    ``PoseEdge``s (scan j in scan i's frame) and their ``PairwiseResult``s.
    A candidate whose refined error exceeds ``max_err`` is dropped; with
    ``weighted`` each edge carries its ``verified_inlier_fraction`` at the
    refined pose (at least 1e-3)."""
    from icp_tpu_torch.slam.pairwise import register_pair

    edges, results = [], []
    for cand in candidates:
        pr = register_pair(clouds[cand.i], clouds[cand.j], config, multiscale=multiscale,
                           init=cand.transform, engine=engine, bucket_quantum=bucket_quantum,
                           pad_sizes=pad_sizes, device=device)
        if max_err is not None and float(pr.err) > max_err:
            continue
        w = 1.0
        if weighted:
            w = max(1e-3, verified_inlier_fraction(clouds[cand.i], clouds[cand.j],
                                                   pr.transform, device=device))
        edges.append(_edge(cand.i, cand.j, pr.transform, w))
        results.append(pr)
    return edges, results
