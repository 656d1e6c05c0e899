"""Plain ICP: the answers a registration has to give, worked out again.

Written from the algorithms' definitions, with NumPy, SciPy's KD-tree
(the normals' neighbours) and the plain PyTorch search of ``nn.py`` (each
iteration's exact nearest neighbours, on the run's device); nothing here
imports the program under test, and nothing takes what the program made.  Each function takes the two clouds as the
benchmark made them (float32 rows, read as float64) and returns the moved
scene, the cumulative transform, the last reported error and the
iterations run.

* Point-to-point (``point_to_point``): each iteration matches every scene
  point to its nearest model point (exact, ``nn.nearest``), keeps the trimmed set
  when ``trim_fraction`` > 0, solves the similarity ``y ~ s R p + t`` in
  closed form (Umeyama: SVD of the centred cross-covariance with the
  reflection corrected, ``s = sqrt(sum |y'|^2 / sum |p'|^2)``, Horn's
  symmetric scale), applies it and reports ``err_factor`` times the mean
  squared distance from the moved points to their matches (the reference
  binary's error is twice the mean: ``err_factor`` 2).
* Trimming keeps the rows whose squared match distance is at most the
  threshold of two rounds of 32-bin histogram refinement of the
  ``1 - trim_fraction`` quantile: the upper edge of the first bin whose
  cumulative count covers the target, so never fewer rows than asked.
* Point-to-plane (``point_to_plane``): model normals by PCA of each model
  point's ``normal_k + 1`` nearest model points (itself included), the
  smallest eigenvector of their covariance; each iteration matches as
  above and takes the damped Gauss-Newton step of the linearised plane
  residual ``n . (R p + t - y)`` (rotation vector and translation,
  Rodrigues' formula), rigid; the error is the mean squared plane residual
  after the step.
* Both stop after the first iteration whose error is not at or above
  ``threshold`` (NaN stops too), or at ``max_iter``.

``precision="float64"`` is the reference.  ``precision="tf32"`` is the
control: every value that enters a product (the coordinates searched for
neighbours, the rows of every sum of products) is first rounded to TF32's
10-bit mantissa, as a TF32 tensor core rounds its inputs, and the state is
kept in float32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy.spatial import cKDTree

from regbench.reference.nn import nearest

DAMPING = 1e-9  # added to the 6x6 Gauss-Newton system's diagonal


class Answer(NamedTuple):
    points: np.ndarray  # (N, 3) the scene moved by ``transform``
    s: float
    R: np.ndarray  # (3, 3)
    t: np.ndarray  # (3,)
    err: float
    iters: int


def tf32(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to TF32 (float32 with 10 explicit mantissa bits, round
    to nearest even), returned as float64."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    lsb = (bits >> 13) & 1
    bits = ((bits + 0xFFF + lsb) >> 13) << 13
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


class _Arith:
    """Where values are rounded: ``q`` before every product, ``keep`` for
    the carried state."""

    def __init__(self, precision: str):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.low = precision == "tf32"

    def q(self, x):
        return tf32(x) if self.low else x

    def keep(self, x):
        return np.asarray(x, dtype=np.float32).astype(np.float64) if self.low else x


def trim_threshold(d2: np.ndarray, keep: float, rounds: int = 2, bins: int = 32) -> float:
    """The squared distance at or under which the kept rows lie: two rounds
    of ``bins``-bin refinement of the ``keep`` quantile of ``d2``; the
    upper edge of the first bin whose cumulative count reaches
    ``keep * len(d2)``."""
    hi = float(d2.max()) + 1e-12
    lo = 0.0
    target = keep * d2.shape[0]
    steps = np.arange(1, bins + 1, dtype=np.float64)
    srt = np.sort(d2)
    for _ in range(rounds):
        edges = lo + (hi - lo) * steps / bins
        cnt = np.searchsorted(srt, edges, side="right")  # rows <= each edge
        j = int(np.argmax(cnt >= target))
        if j > 0:
            lo = float(edges[j - 1])
        hi = float(edges[j])
    return hi


def _umeyama(p, y, w, ar: _Arith):
    """(s, R, t) with y ~ s R p + t over the rows of weight ``w`` (0 or 1)."""
    n = w.sum()
    mp = (w[:, None] * p).sum(0) / n
    my = (w[:, None] * y).sum(0) / n
    pc, yc = ar.q(p - mp), ar.q(y - my)
    S = (w[:, None] * pc).T @ yc  # sum p' y'^T
    gp = (w * (pc * pc).sum(1)).sum()
    gy = (w * (yc * yc).sum(1)).sum()
    U, _, Vt = np.linalg.svd(S)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
    s = np.sqrt(gy / gp)
    return s, R, my - s * R @ mp


def _rodrigues(omega: np.ndarray) -> np.ndarray:
    theta = float(np.linalg.norm(omega))
    if theta < 1e-12:
        return np.eye(3)
    k = omega / theta
    K = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def pca_normals(model: np.ndarray, k: int, precision: str = "float64") -> np.ndarray:
    """(M, 3) unit normals: the smallest eigenvector of the covariance of
    each point's ``k`` nearest points (itself included)."""
    ar = _Arith(precision)
    x = ar.q(model)
    _, idx = cKDTree(x).query(x, k=k, workers=-1)
    out = np.empty_like(model)
    for a in range(0, model.shape[0], 1 << 16):  # blocks of rows, to bound memory
        nb = model[idx[a:a + (1 << 16)]]  # (b, k, 3)
        c = ar.q(nb - nb.mean(1, keepdims=True))
        C = np.einsum("bki,bkj->bij", c, c)
        out[a:a + (1 << 16)] = np.linalg.eigh(C)[1][:, :, 0]
    return out


def point_to_point(model, scene, *, max_iter: int, threshold: float, err_factor: float = 2.0,
                   trim_fraction: float = 0.0, precision: str = "float64",
                   device: str = "cpu") -> Answer:
    """Similarity point-to-point ICP of ``scene`` onto ``model``."""
    ar = _Arith(precision)
    model = np.asarray(model, dtype=np.float64)
    p = np.asarray(scene, dtype=np.float64)
    searched = ar.q(model)
    s_tot, R_tot, t_tot = 1.0, np.eye(3), np.zeros(3)
    err, it = float("inf"), 0
    ones = np.ones(p.shape[0])
    while it < max_iter:
        y = model[nearest(searched, ar.q(p), device)]
        w = ones
        if trim_fraction > 0.0:
            d2 = ((y - p) ** 2).sum(1)
            w = (d2 <= trim_threshold(d2, 1.0 - trim_fraction)).astype(np.float64)
        s, R, t = _umeyama(p, y, w, ar)
        p = ar.keep(s * ar.q(p) @ ar.q(R).T + t)
        s_tot, R_tot, t_tot = s * s_tot, R @ R_tot, s * R @ t_tot + t
        d = y - p
        err = float(err_factor * (w * (d * d).sum(1)).sum() / w.sum())
        it += 1
        if not err >= threshold:
            break
    return Answer(points=p, s=float(s_tot), R=R_tot, t=t_tot, err=err, iters=it)


def point_to_plane(model, scene, *, max_iter: int, threshold: float, normal_k: int = 16,
                   precision: str = "float64", device: str = "cpu") -> Answer:
    """Rigid point-to-plane ICP of ``scene`` onto ``model``, the model's
    normals from its ``normal_k + 1`` nearest points."""
    ar = _Arith(precision)
    model = np.asarray(model, dtype=np.float64)
    p = np.asarray(scene, dtype=np.float64)
    searched = ar.q(model)
    normals = pca_normals(model, min(normal_k + 1, model.shape[0]), precision)
    R_tot, t_tot = np.eye(3), np.zeros(3)
    err, it = float("inf"), 0
    while it < max_iter:
        idx = nearest(searched, ar.q(p), device)
        y, nv = model[idx], normals[idx]
        r = (ar.q(nv) * ar.q(p - y)).sum(1)
        J = ar.q(np.concatenate([np.cross(p, nv), nv], axis=1))
        A = J.T @ J + DAMPING * np.eye(6)
        x = -np.linalg.solve(A, J.T @ ar.q(r))
        R, t = _rodrigues(x[:3]), x[3:]
        p = ar.keep(ar.q(p) @ ar.q(R).T + t)
        R_tot, t_tot = R @ R_tot, R @ t_tot + t
        res = (nv * (p - y)).sum(1)
        err = float((res * res).mean())
        it += 1
        if not err >= threshold:
            break
    return Answer(points=p, s=1.0, R=R_tot, t=t_tot, err=err, iters=it)
