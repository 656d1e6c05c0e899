"""Global registration: FPFH correspondences and batched RANSAC (port of
``icp_tpu/engine/global_reg.py``).

The ICP engines are local: they need a start within the basin of
convergence.  This module finds one from nothing: match FPFH descriptors
(``ops/fpfh.py``) between the clouds, weight the matches by their spectral
geometric consistency, and fit a similarity by RANSAC over all hypotheses
at once: (K, 3) triplets, K batched Horn solves (``solver="qcp"`` on a
leading hypothesis axis), a (K, S) inlier count, and an annealed refit of
the best.  The result warm-starts any engine
(``register_pair(init="fpfh")``).

The triplets are drawn with a ``torch.Generator`` seeded from ``seed``
(``torch.multinomial`` over the sampling weights, the counterpart of JAX's
``jax.random.categorical``); the two packages draw different numbers from
one seed, so the draw stays apart from what follows it
(``ransac_from_triplets`` takes the triplets) and the tests feed JAX's own
triplets to it.  Medians average the two middle values of an even count,
as ``jnp.median`` does.  Nothing is read to the host between the kNN and
the result; every matmul runs in full float32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from icp_tpu_torch.ops.alignment import Similarity, alignment_from_stats, compute_alignment_stats
from icp_tpu_torch.utils.precision import in_full_float32


class GlobalRegResult(NamedTuple):
    transform: Similarity  # maps scene into the model frame
    inlier_fraction: torch.Tensor  # () the refined pose's inlier share
    n_mutual: torch.Tensor  # () mutual feature matches


def median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of all elements: the mean of the two middle values of
    an even count (``torch.median`` returns the lower one), NaN if any is."""
    v = torch.sort(x.reshape(-1)).values
    n = v.shape[0]
    mid = (v[(n - 1) // 2] + v[n // 2]) * 0.5
    return torch.where(torch.isnan(v).any(), torch.full_like(mid, float("nan")), mid)


def median_spacing(points: torch.Tensor) -> torch.Tensor:
    """The median distance of each point to its nearest other point (K6 at
    k = 2), on the device: the scale of the inlier radii of the global
    pipeline and of the closure checks."""
    from icp_tpu_torch.kernels.knn_dense import knn_dense

    pts = points.to(torch.float32).contiguous()
    d2, _ = knn_dense(pts, pts, min(2, pts.shape[0]))
    return median(torch.sqrt(d2[:, -1].clamp(min=0.0)))


@in_full_float32
def match_features(f_model: torch.Tensor, f_scene: torch.Tensor, *, mutual: bool = True):
    """Nearest neighbours in descriptor space: ``(idx (Ns,) int64, valid
    (Ns,) bool)``, each scene row's best model row and whether the match is
    mutual, by the matmul expansion in full float32 (descriptor gaps are
    small; TF32 would flip argmins)."""
    fm = f_model.to(torch.float32)
    fs = f_scene.to(torch.float32)
    cross = fs @ fm.T
    fwd = torch.argmin((fm * fm).sum(1)[None, :] - 2.0 * cross, dim=1)
    if not mutual:
        return fwd, torch.ones(fwd.shape, dtype=torch.bool, device=fwd.device)
    back = torch.argmin((fs * fs).sum(1)[None, :] - 2.0 * cross.T, dim=1)
    return fwd, back[fwd] == torch.arange(fs.shape[0], device=fs.device)


@in_full_float32
def compatibility_scores(scene_pts: torch.Tensor, model_pts: torch.Tensor,
                         valid: torch.Tensor, *, sigma, n_power_iters: int = 30) -> torch.Tensor:
    """Spectral geometric-consistency score of each putative correspondence
    (Leordeanu & Hebert, ICCV '05): the leading eigenvector, by power
    iteration, of the (S, S) affinity exp(-(|s_i - s_j| - |m_i - m_j|)^2 /
    (2 sigma^2)) over the valid matches; (S,) non-negative, max-normalised."""
    dt = torch.float32
    s, m = scene_pts.to(dt), model_pts.to(dt)
    w = valid.to(dt)

    def pdist(p):
        g = p @ p.T
        n2 = torch.diagonal(g)
        return torch.sqrt((n2[:, None] + n2[None, :] - 2.0 * g).clamp(min=0.0))

    sig = torch.as_tensor(sigma, dtype=dt, device=s.device).clamp(min=1e-12)
    C = torch.exp(-torch.square((pdist(s) - pdist(m)) / sig) * 0.5) * (w[:, None] * w[None, :])
    C = C * (1.0 - torch.eye(C.shape[0], dtype=dt, device=C.device))
    x = w / w.sum().clamp(min=1.0)
    for _ in range(n_power_iters):
        x = C @ x
        x = x / torch.linalg.norm(x).clamp(min=1e-30)
    return x / x.max().clamp(min=1e-30)


def draw_triplets(valid: torch.Tensor, n_hypotheses: int, generator: torch.Generator,
                  sample_weights: torch.Tensor | None = None) -> torch.Tensor:
    """(K, 3) correspondence indices drawn with replacement, each with
    probability proportional to max(weight, 1e-30) (JAX's categorical over
    log-weights), the weights ``sample_weights`` times ``valid``."""
    w = valid.to(torch.float32)
    sw = w if sample_weights is None else sample_weights.to(torch.float32) * w
    return torch.multinomial(sw.clamp(min=1e-30), 3 * n_hypotheses, replacement=True,
                             generator=generator).reshape(n_hypotheses, 3)


def _moved(sim: Similarity, pts: torch.Tensor) -> torch.Tensor:
    return sim.s * (pts @ sim.R.T) + sim.t


@in_full_float32
def ransac_from_triplets(scene_pts: torch.Tensor, model_pts: torch.Tensor, valid: torch.Tensor,
                         tri: torch.Tensor, *, inlier_tau, with_scale: bool = False,
                         edge_similarity: float = 0.9, refine_iters: int = 4):
    """RANSAC after the draw: the triplets' edge check (an absolute slack of
    2 tau an edge; under ``with_scale`` the edges compared after the
    triplet's least-squares scale), K batched 3-point Horn solves, every
    hypothesis scored against every valid match at 2 tau, and the best
    refit on its inliers ``refine_iters`` times as the radius anneals from
    3 tau to tau.  Returns ``(Similarity, inlier fraction at tau)``."""
    dt = scene_pts.dtype
    w = valid.to(dt)
    tri = tri.long()
    p3, y3 = scene_pts[tri], model_pts[tri]  # (K, 3, 3)

    def edges(x):  # (K, 3, 3) -> (K, 3) edge lengths
        return torch.stack([torch.linalg.norm(x[:, 0] - x[:, 1], dim=1),
                            torch.linalg.norm(x[:, 1] - x[:, 2], dim=1),
                            torch.linalg.norm(x[:, 2] - x[:, 0], dim=1)], dim=1)

    tau = torch.as_tensor(inlier_tau, dtype=dt, device=scene_pts.device)
    ep, ey = edges(p3), edges(y3)
    nondegenerate = (ep > 1e-9).all(1) & (ey > 1e-9).all(1)
    s_hat = (ey.sum(1) / ep.sum(1).clamp(min=1e-30) if with_scale
             else torch.ones(ep.shape[0], dtype=dt, device=ep.device))
    ep_s = s_hat[:, None] * ep
    slack = (1.0 - edge_similarity) * torch.maximum(ep_s, ey) + 2.0 * tau
    ok = (nondegenerate & ((ey - ep_s).abs() <= slack).all(1)).to(dt)

    sims = alignment_from_stats(compute_alignment_stats(p3, y3), solver="qcp",
                                with_scale=with_scale)
    moved = (sims.s[:, None, None] * torch.einsum("kab,sb->ksa", sims.R, scene_pts)
             + sims.t[:, None, :])  # (K, S, 3)
    r2 = ((moved - model_pts[None]) ** 2).sum(2)
    score = ((r2 < (2.0 * tau) ** 2).to(dt) * w[None, :]).sum(1) * ok
    best = torch.argmax(score).reshape(1)  # a 1-element index: no host read
    sim = Similarity(*(v.index_select(0, best)[0] for v in sims))

    denom = max(refine_iters - 1, 1)
    for i in range(refine_iters):
        tau_i = tau * 3.0 ** (1.0 - i / denom)
        r2_1 = ((_moved(sim, scene_pts) - model_pts) ** 2).sum(1)
        w_in = (r2_1 < tau_i * tau_i).to(dt) * w
        w_in = torch.where(w_in.sum() < 3.0, w, w_in)  # all outside tau: keep every match
        sim = alignment_from_stats(compute_alignment_stats(scene_pts, model_pts, weights=w_in),
                                   solver="qcp", with_scale=with_scale)
    r2_f = ((_moved(sim, scene_pts) - model_pts) ** 2).sum(1)
    n_in = ((r2_f < tau * tau).to(dt) * w).sum()
    return sim, (n_in / w.sum().clamp(min=1.0)).to(dt)


def ransac_alignment(scene_pts: torch.Tensor, model_pts: torch.Tensor, valid: torch.Tensor, *,
                     inlier_tau, seed: int = 0, generator: torch.Generator | None = None,
                     n_hypotheses: int = 512, with_scale: bool = False,
                     edge_similarity: float = 0.9, refine_iters: int = 4,
                     sample_weights: torch.Tensor | None = None):
    """Batched-hypothesis RANSAC over putative correspondences (S, 3):
    ``n_hypotheses`` triplets drawn from ``generator`` (default: a new one
    seeded with ``seed``), then ``ransac_from_triplets``.  Returns
    ``(Similarity, inlier fraction)``."""
    if generator is None:
        generator = torch.Generator(device=scene_pts.device).manual_seed(seed)
    tri = draw_triplets(valid, n_hypotheses, generator, sample_weights)
    return ransac_from_triplets(scene_pts, model_pts, valid, tri, inlier_tau=inlier_tau,
                                with_scale=with_scale, edge_similarity=edge_similarity,
                                refine_iters=refine_iters)


def register_features(m: torch.Tensor, s: torch.Tensor, f_m: torch.Tensor, f_s: torch.Tensor,
                      tau, *, generator: torch.Generator, n_hypotheses: int, with_scale: bool):
    """The pipeline after the features: mutual matches, their spectral
    scores as sampling weights, RANSAC.  ``(Similarity, fraction, mutual
    matches)``, all on the device."""
    idx, valid = match_features(f_m, f_s, mutual=True)
    matched = m[idx]
    scores = compatibility_scores(s, matched, valid, sigma=tau)
    sim, frac = ransac_alignment(s, matched, valid, inlier_tau=tau, generator=generator,
                                 n_hypotheses=n_hypotheses, with_scale=with_scale,
                                 sample_weights=scores)
    return sim, frac, valid.sum().to(torch.int32)


@in_full_float32
def global_register(model, scene, *, voxel: float | None = None, k: int = 16,
                    n_hypotheses: int = 512, inlier_tau: float | None = None,
                    with_scale: bool = False, seed: int = 0, max_points: int = 4096,
                    device=None) -> GlobalRegResult:
    """Estimate the scene -> model similarity with no initial guess.

    On the host: an optional voxel downsample, then a uniform subsample to
    at most ``max_points`` rows; on the device: the inlier radius (3x the
    model's median nearest-neighbour spacing unless ``inlier_tau`` is
    given), FPFH of both clouds (K6 for the neighbours at these sizes),
    mutual matching, spectral scores and RANSAC.  Devices as in ``icp``:
    the card unless ``device="cpu"``."""
    from icp_tpu_torch.engine.icp import as_points
    from icp_tpu_torch.ops.fpfh import fpfh_features
    from icp_tpu_torch.ops.voxel import voxel_downsample_np

    m_np = np.asarray(model, np.float32)
    s_np = np.asarray(scene, np.float32)
    if voxel is not None:
        m_np, _ = voxel_downsample_np(m_np, voxel, device=device)
        s_np, _ = voxel_downsample_np(s_np, voxel, device=device)

    def sub(x):
        return np.ascontiguousarray(x[::max(1, int(np.ceil(x.shape[0] / max_points)))])

    m = as_points(sub(m_np), torch.float32, device)
    s = as_points(sub(s_np), torch.float32, m.device)
    tau = (3.0 * median_spacing(m).clamp(min=1e-12) if inlier_tau is None
           else torch.tensor(inlier_tau, dtype=torch.float32, device=m.device))
    sim, frac, n_mutual = register_features(
        m, s, fpfh_features(m, k=k), fpfh_features(s, k=k), tau,
        generator=torch.Generator(device=m.device).manual_seed(seed),
        n_hypotheses=n_hypotheses, with_scale=with_scale)
    return GlobalRegResult(transform=sim, inlier_fraction=frac, n_mutual=n_mutual)
