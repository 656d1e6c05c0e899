"""The one request generator: a cell's configuration and traffic mix, both
data files, and ``--seed`` give every registration's two clouds.

The configuration names its source's files, each read from the checkout
and held to its SHA-256 (``load_source``):

* ``points``: the base cloud (horse: ``data/horse_ref.txt``, 48,485 rows);
* ``motions``: the source's own scenes of that cloud (horse:
  ``data/horse_tr1.txt`` and ``data/horse_tr2.txt``), each the base moved
  row for row by an exact similarity.  The similarity is fitted from the
  file (closed form over the paired rows; residual under 1e-6).

Request ``i`` of a run is made on the run's device from ``(seed, i)``
alone, so the reference can make it again after the window:

* a draw of the base has ``rows`` rows.  Row ``j`` is base point
  ``j mod P``.  Where ``surface_radius`` is above 0, it is moved to a
  point uniform in the disc of that radius in the base point's tangent
  plane (the plane of its ``surface_k`` nearest base points, PCA), so that
  ``rows`` beyond ``P`` sample the same surface more densely instead of
  stacking copies of it; then Gaussian noise of ``jitter`` is added;
* the model is a draw with ``model_jitter``: one for the run, or a new
  one every request where ``model_per_request`` is true;
* the scene is another draw, with ``scene_jitter``, moved by the source's motion
  ``(i + seed) mod len(motions)``: every seed sends the source's scenes in
  turn;
* the mix's ``clutter_fraction`` of the scene's rows, seeded, is replaced
  by points uniform in the model's bounding box enlarged
  ``clutter_box_scale`` times about its centre.

A mix also states what its engine makes the grid searches carry, for the
roofline readers (``metrics/``), which never infer it from the entry or
the reference's name:

* ``k4_payload_cols``: the float32 columns a model row carries through
  K4 beside its coordinates (0 for point-to-point; 3, the model's
  normals, for point-to-plane, symmetric and GICP);
* ``k7_searches``: the K7 kNN searches of one cloud among itself that a
  registration makes (1 where the model's normals are estimated; 2 where
  the scene's are too, as symmetric ICP and GICP do).  A mix whose
  registrations make none leaves it out.
"""

from __future__ import annotations

import hashlib
import math
import os
from typing import NamedTuple

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Request(NamedTuple):
    model: torch.Tensor  # (M, 3) float32
    scene: torch.Tensor  # (N, 3) float32


class Source(NamedTuple):
    points: np.ndarray  # (P, 3) float64, the base cloud
    motions: list  # [(s, R (3, 3), t (3,))], float64: the source's scenes of it


def u64_seed(*words: int) -> int:
    """A 64-bit seed from whole numbers of any sign and size."""
    seq = np.random.SeedSequence([w % (1 << 64) for w in words])
    return int(seq.generate_state(1, np.uint64)[0])


def load_points(path: str) -> np.ndarray:
    """An (N, 3) float64 cloud from a CSV file with one header line."""
    return np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float64,
                      usecols=(0, 1, 2)).reshape(-1, 3)


def _read_checked(config: dict, rel: str) -> np.ndarray:
    path = os.path.join(ROOT, rel)
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    want = config["sha256"][rel]
    if digest != want:
        raise SystemExit(f"{rel}: SHA-256 {digest}, the configuration states {want}")
    return load_points(path)


def fit_similarity(p: np.ndarray, y: np.ndarray):
    """(s, R, t) with y ~ s R p + t over paired rows (closed form)."""
    mp, my = p.mean(0), y.mean(0)
    pc, yc = p - mp, y - my
    U, _, Vt = np.linalg.svd(pc.T @ yc)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
    s = math.sqrt((yc * yc).sum() / (pc * pc).sum())
    return s, R, my - s * R @ mp


def load_source(config: dict) -> Source:
    """The configuration's base cloud and its source's motions."""
    points = _read_checked(config, config["points"])
    motions = []
    for rel in config["motions"]:
        moved = _read_checked(config, rel)
        s, R, t = fit_similarity(points, moved)
        residual = float(np.abs(s * points @ R.T + t - moved).max())
        if residual > 1e-6:
            raise SystemExit(f"{rel} is no similarity of {config['points']} ({residual:.3g})")
        motions.append((s, R, t))
    return Source(points=points, motions=motions)


def tangent_frames(points: np.ndarray, k: int) -> tuple:
    """Two unit vectors spanning each point's tangent plane: the two largest
    eigenvectors of the covariance of its ``k`` nearest points."""
    from scipy.spatial import cKDTree

    _, idx = cKDTree(points).query(points, k=min(k, points.shape[0]))
    nb = points[idx]
    c = nb - nb.mean(1, keepdims=True)
    vecs = np.linalg.eigh(np.einsum("bki,bkj->bij", c, c))[1]
    return vecs[:, :, 2], vecs[:, :, 1]


class Generator:
    """Requests of one run: ``make(i)`` gives request ``i``."""

    def __init__(self, config: dict, mix: dict, seed: int, device, source: Source):
        self.config, self.mix, self.seed = config, mix, seed
        self.motions = source.motions
        self.device = torch.device(device)
        rows = int(config["rows"])
        j = np.arange(rows) % source.points.shape[0]

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                                   device=self.device)

        self.base = dev(source.points[j])
        self.radius = float(config.get("surface_radius", 0.0))
        if self.radius > 0.0:
            u, v = tangent_frames(source.points, int(config["surface_k"]))
            self.u, self.v = dev(u[j]), dev(v[j])
        self.fixed_model = None
        if not config.get("model_per_request", False):
            self.fixed_model = self._draw(torch.Generator(self.device).manual_seed(
                u64_seed(seed, 0x6d6f64)), float(config["model_jitter"])).to(torch.float32)

    def _draw(self, g: torch.Generator, jitter: float) -> torch.Tensor:
        """A draw of the base, float64."""
        x = self.base
        if self.radius > 0.0:
            r, a = torch.rand((2, x.shape[0]), generator=g, dtype=torch.float64,
                              device=self.device)
            r = self.radius * torch.sqrt(r)
            a = 2.0 * math.pi * a
            x = x + (r * torch.cos(a))[:, None] * self.u + (r * torch.sin(a))[:, None] * self.v
        if jitter > 0.0:
            x = x + jitter * torch.randn(x.shape, generator=g, dtype=torch.float64,
                                         device=self.device)
        return x

    def motion(self, index: int):
        """The source's motion (s, R, t) that request ``index`` applies."""
        return self.motions[(index + self.seed) % len(self.motions)]

    def make(self, index: int) -> Request:
        g = torch.Generator(self.device).manual_seed(u64_seed(self.seed, index))
        if self.fixed_model is None:
            model = self._draw(g, float(self.config["model_jitter"])).to(torch.float32)
        else:
            model = self.fixed_model
        s, R, t = self.motion(index)
        A = torch.as_tensor(s * R.T, dtype=torch.float64, device=self.device)
        b = torch.as_tensor(t, dtype=torch.float64, device=self.device)
        scene = self._draw(g, float(self.config["scene_jitter"])) @ A + b
        frac = float(self.mix.get("clutter_fraction", 0.0))
        if frac > 0.0:
            n = scene.shape[0]
            rows = torch.randperm(n, generator=g, device=self.device)[:round(frac * n)]
            lo, hi = model.amin(0).double(), model.amax(0).double()
            half = 0.5 * (hi - lo) * float(self.mix["clutter_box_scale"])
            u = torch.rand((rows.shape[0], 3), generator=g, dtype=torch.float64,
                           device=self.device)
            scene[rows] = 0.5 * (lo + hi) - half + 2.0 * half * u
        return Request(model=model, scene=scene.to(torch.float32))
