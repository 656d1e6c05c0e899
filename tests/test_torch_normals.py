"""The port's normal estimation vs the JAX package's, on the clouds of
``tests/test_point_to_plane.py`` (a plane, a sphere, a wavy surface).

The neighbour indices are exact on both sides (``test_torch_knn.py``); the
covariances are summed in another order, so the normals agree to rounding.
Orientation is arbitrary and the point-to-plane metric is blind to it, so
the check is ``|n_port . n_jax| >= 1 - 1e-4`` on all but 0.1% of points
(a neighbourhood with two near-equal small eigenvalues may turn its normal
on rounding alone).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_tpu.ops import normals as jn
from icp_tpu_torch.kernels import knn_dense as tkd
from icp_tpu_torch.ops import normals as tn


def _plane(rng, n=500):
    xy = rng.uniform(-1, 1, (n, 2))
    return np.column_stack([xy, 0.3 * xy[:, 0] - 0.2 * xy[:, 1] + 1.0])


def _sphere(rng, n=800):
    v = rng.standard_normal((n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _wavy(rng, n=1500):
    xy = rng.uniform(-1, 1, (n, 2))
    return np.column_stack([xy, 0.25 * np.sin(3 * xy[:, 0]) * np.cos(2 * xy[:, 1])])


CLOUDS = {"plane": _plane, "sphere": _sphere, "wavy": _wavy}


def _agree(got, want):
    dots = np.abs(np.sum(np.asarray(got, np.float64) * np.asarray(want, np.float64), axis=1))
    bad = int(np.sum(dots < 1 - 1e-4))
    assert bad <= len(dots) // 1000, (bad, float(dots.min()))


@pytest.mark.parametrize("method", ["dense", "grid"])
@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_normals_match_jax(cloud, method):
    pts = CLOUDS[cloud](np.random.default_rng(len(cloud))).astype(np.float32)
    want = np.asarray(jn.estimate_normals(jnp.asarray(pts), k=16, method=method))
    got = tn.estimate_normals(pts, k=16, method=method, device="cpu")
    assert got.shape == pts.shape and got.dtype == torch.float32
    _agree(got.numpy(), want)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0, atol=1e-5)


def test_normals_grid_equals_dense_in_the_port():
    """Same neighbour sets (K7 == K6) give the same normals, bit for bit."""
    pts = torch.tensor(_wavy(np.random.default_rng(7), 1200), dtype=torch.float32)
    a = tn.estimate_normals(pts, k=16, method="dense")
    b = tn.estimate_normals(pts, k=16, method="grid")
    assert torch.equal(a, b)


def test_normals_float64_and_auto_method():
    pts = _sphere(np.random.default_rng(8), 600)
    want = np.asarray(jn.estimate_normals(jnp.asarray(pts, jnp.float64), k=12))
    got = tn.estimate_normals(torch.tensor(pts, dtype=torch.float64), k=12)
    assert got.dtype == torch.float64  # the PCA runs in the cloud's dtype
    _agree(got.numpy(), want)
    assert np.median(np.abs(np.sum(got.numpy() * pts, axis=1))) > 0.99  # radial


def test_knn_self_neighbour_and_k_eff():
    """k + 1 neighbours with the point itself first; k_eff = min(k + 1, n)."""
    pts = torch.tensor(_plane(np.random.default_rng(9), 12), dtype=torch.float32)
    idx = tn.knn_indices(pts, 12, method="dense")
    np.testing.assert_array_equal(idx[:, 0].numpy(), np.arange(12))
    got = tn.estimate_normals(pts, k=16)  # k_eff = 12: every point
    assert torch.isfinite(got).all()
    assert torch.equal(tkd.knn_dense(pts, pts, 12)[1], idx)


def test_orient_normals_matches_jax():
    pts = np.array([[1.0, 0, 0], [0, 2.0, 0], [0, 0, -3.0], [1.0, 1.0, 0]], np.float32)
    nrm = np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, 1.0], [1.0, -1.0, 0]], np.float32)
    for vp in ((0.0, 0.0, 0.0), (5.0, 5.0, 5.0)):
        want = np.asarray(jn.orient_normals(jnp.asarray(pts), jnp.asarray(nrm), vp))
        got = tn.orient_normals(torch.tensor(pts), torch.tensor(nrm), vp)
        np.testing.assert_array_equal(got.numpy(), want)
    out = tn.orient_normals(torch.tensor(pts), torch.tensor(nrm))
    assert out[0, 0] == -1.0 and out[1, 1] == -1.0  # toward the origin


def test_numpy_input_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tn.estimate_normals(_plane(np.random.default_rng(10), 50))
