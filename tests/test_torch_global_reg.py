"""The port's voxel downsampling, FPFH features and global registration
(``ops/voxel.py``, ``ops/fpfh.py``, ``engine/global_reg.py``) against the
JAX package's, the counterparts of ``tests/test_voxel.py`` and
``tests/test_global_reg.py``.

Inputs are made with numpy from a seed (or cut from the bundled clouds)
and handed to both packages; JAX's kNN kernels run in interpret mode, as
its own tests run them.  RANSAC draws its triplets from each package's own
generator, so the port's ``ransac_from_triplets`` is fed JAX's triplets.
Tolerances are stated case by case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_tpu.engine import global_reg as jg
from icp_tpu.io.csv import load_matrix
from icp_tpu.kernels.knn_pallas import knn_pallas
from icp_tpu.ops import fpfh as jf
from icp_tpu.ops import voxel as jv
from icp_tpu_torch.engine import global_reg as tg
from icp_tpu_torch.ops import fpfh as tf
from icp_tpu_torch.ops import voxel as tv
from tests.conftest import data_path

CPU = "cpu"


def _rot(rng):
    q, r = np.linalg.qr(rng.standard_normal((3, 3)))
    q = q @ np.diag(np.sign(np.diag(r)))
    return q if np.linalg.det(q) > 0 else -q


def _rot_err_deg(R_got, R_true):
    c = (np.trace(np.asarray(R_got) @ np.asarray(R_true).T) - 1.0) / 2.0
    return np.rad2deg(np.arccos(np.clip(c, -1.0, 1.0)))


# --------------------------------------------------------------------------
# voxel
# --------------------------------------------------------------------------

@pytest.mark.parametrize("voxel", [0.3, 0.05])
def test_voxel_downsample_matches_jax(voxel):
    """Same voxels in the same order, centroids within 1 ulp-scale (1e-6:
    the same sums in the same order, JAX's division fused otherwise)."""
    pts = np.random.default_rng(1).standard_normal((700, 3)).astype(np.float32)
    out, mask, n = tv.voxel_downsample(torch.tensor(pts), voxel, capacity=700)
    jout, jmask, jn = jv.voxel_downsample(jnp.asarray(pts), voxel, capacity=700)
    assert int(n) == int(jn)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6, atol=1e-7)
    got, n_np = tv.voxel_downsample_np(pts, voxel, device=CPU)
    want, jn_np = jv.voxel_downsample_np(pts, voxel)
    assert n_np == jn_np == int(n)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_voxel_bucketed_and_empty_clouds():
    """Rows past ``n_valid`` join row 0's voxel with weight 0, as JAX's; an
    empty cloud gives zeros and a count of 0."""
    pts = np.random.default_rng(2).uniform(0, 2, (300, 3)).astype(np.float32)
    padded = np.concatenate([pts, np.full((212, 3), 7.0, np.float32)])
    out, mask, n = tv.voxel_downsample(torch.tensor(padded), 0.25, capacity=512, n_valid=300)
    jout, jmask, jn = jv.voxel_downsample(jnp.asarray(padded), 0.25, capacity=512, n_valid=300)
    ref, _, rn = tv.voxel_downsample(torch.tensor(pts), 0.25, capacity=512)
    assert int(n) == int(jn) == int(rn)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-6, atol=1e-7)
    e_out, e_mask, e_n = tv.voxel_downsample(torch.zeros((0, 3)), 0.1, capacity=8)
    assert e_out.shape == (8, 3) and not e_mask.any() and int(e_n) == 0
    got, n0 = tv.voxel_downsample_np(np.zeros((0, 3), np.float32), 0.1, device=CPU)
    assert got.shape == (0, 3) and n0 == 0 == jv.voxel_downsample_np(np.zeros((0, 3)), 0.1)[1]


def test_voxel_capacity_overflow_is_reported():
    pts = np.random.default_rng(3).standard_normal((128, 3)).astype(np.float32)
    v = float(pts.max() - pts.min()) / 1000.0
    out, mask, n = tv.voxel_downsample(torch.tensor(pts), v, capacity=16)
    jout, jmask, jn = jv.voxel_downsample(jnp.asarray(pts), v, capacity=16)
    assert int(n) == int(jn) == 128 and int(mask.sum()) == 16
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------
# FPFH
# --------------------------------------------------------------------------

def _cow(step):
    return load_matrix(data_path("cow_ref.txt")).astype(np.float32)[::step]


def _features_close(got, want):
    """Histograms are bin-quantised: an angle a few ulp from a bin edge (the
    packages' normals differ by ~1e-7, their atan2 and rsqrt in the last
    bits) moves 1/k of a histogram's mass to the next bin, and every row
    that mixes that neighbour's SPFH moves with it.  Each row sums to 300;
    held: every row within L1 6 (2% of a row), the mean within 0.25, and
    three rows in four within 1e-3 (on cow: median 2e-5, the 90th
    percentile 0.08-0.1)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    l1 = np.abs(got - want).sum(1)
    assert l1.max() < 6.0, float(l1.max())
    assert l1.mean() < 0.25, float(l1.mean())
    assert (l1 < 1e-3).mean() > 0.75, float((l1 < 1e-3).mean())


@pytest.mark.parametrize("k,method", [(16, "dense"), (32, "dense"), (16, "grid"), (32, "grid")])
def test_fpfh_features_match_jax(k, method):
    """FPFH at k 16 and 32 (kNN fetches 64 neighbours: K6's and K7's lists
    of two slots a lane) on ~970 cow points, dense and grid neighbours."""
    pts = _cow(3)
    got = tf.fpfh_features(pts, k=k, method=method, device=CPU)
    want = jf.fpfh_features(jnp.asarray(pts), k=k, method=method)
    _features_close(got.numpy(), want)
    blocks = got.numpy().reshape(-1, 3, 11).sum(2)
    np.testing.assert_allclose(blocks, 100.0, atol=1e-3)


def test_fpfh_from_neighbors_and_orientation_match_jax():
    """Given the same neighbours and (seeded random) normals, the same
    bounds with no kNN or PCA in the way; both orientation rules flip the
    same normals."""
    pts = _cow(6)
    rng = np.random.default_rng(4)
    nrm = rng.standard_normal(pts.shape).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    idx = np.asarray(knn_pallas(jnp.asarray(pts), jnp.asarray(pts), 24)[1])
    tp, tn, ti = torch.tensor(pts), torch.tensor(nrm), torch.tensor(idx)
    np.testing.assert_array_equal(tf.orient_local(tp, tn, ti).numpy(),
                                  np.asarray(jf.orient_local(pts, nrm, idx)))
    np.testing.assert_array_equal(tf.orient_outward(tp, tn).numpy(),
                                  np.asarray(jf.orient_outward(pts, nrm)))
    got = tf.fpfh_from_neighbors(tp, tn, ti[:, :17], orient_idx=ti)
    want = jf.fpfh_from_neighbors(jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(idx[:, :17]),
                                  orient_idx=jnp.asarray(idx))
    _features_close(got.numpy(), want)


# --------------------------------------------------------------------------
# matching, spectral scores, RANSAC
# --------------------------------------------------------------------------

def test_match_features_matches_jax():
    rng = np.random.default_rng(5)
    fm = rng.uniform(0, 10, (300, 33)).astype(np.float32)
    fs = np.concatenate([fm[rng.permutation(300)[:200]] + 0.01 * rng.standard_normal((200, 33)),
                         rng.uniform(0, 10, (60, 33))]).astype(np.float32)
    idx, valid = tg.match_features(torch.tensor(fm), torch.tensor(fs))
    jidx, jvalid = jg.match_features(jnp.asarray(fm), jnp.asarray(fs))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    same, ok = tg.match_features(torch.tensor(fm), torch.tensor(fm))
    assert ok.all() and torch.equal(same, torch.arange(300))


def test_compatibility_scores_match_jax():
    """60 rigid matches and 140 outliers: scores within 1e-5 of JAX's (30
    float32 power steps), every true match above every outlier."""
    rng = np.random.default_rng(6)
    R, t = _rot(rng), rng.standard_normal(3)
    s_true = rng.uniform(-1, 1, (60, 3))
    s = np.concatenate([s_true, rng.uniform(-1, 1, (140, 3))]).astype(np.float32)
    m = np.concatenate([s_true @ R.T + t, rng.uniform(-1, 1, (140, 3))]).astype(np.float32)
    valid = np.ones(200, bool)
    valid[-5:] = False
    got = tg.compatibility_scores(torch.tensor(s), torch.tensor(m), torch.tensor(valid),
                                  sigma=0.01)
    want = jg.compatibility_scores(jnp.asarray(s), jnp.asarray(m), jnp.asarray(valid),
                                   sigma=0.01)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert got[:60].min() > got[60:].max()


def _jax_triplets(valid, key, n_hypotheses, weights=None):
    """JAX's draw inside ``ransac_alignment`` (global_reg.py:148-153)."""
    w = jnp.asarray(valid).astype(jnp.float32)
    sw = w if weights is None else jnp.asarray(weights, jnp.float32) * w
    logits = jnp.log(jnp.maximum(sw, 1e-30))
    return np.asarray(jax.random.categorical(key, logits[None, :], shape=(n_hypotheses, 3)))


@pytest.mark.parametrize("with_scale", [False, True])
def test_ransac_from_jax_triplets_matches_jax(with_scale):
    """50 inliers of a similarity and 150 outliers: fed JAX's own triplets,
    the port lands on JAX's hypothesis and refit (rotation within 1e-4,
    fraction equal); the truth within JAX's test's bounds."""
    rng = np.random.default_rng(7)
    R, t = _rot(rng), rng.standard_normal(3)
    s_fac = 1.37 if with_scale else 1.0
    p_in = rng.uniform(-1, 1, (50, 3))
    scene = np.concatenate([p_in, rng.uniform(-1, 1, (150, 3))]).astype(np.float32)
    model = np.concatenate([s_fac * p_in @ R.T + t, rng.uniform(-1, 1, (150, 3))]).astype(
        np.float32)
    valid = np.ones(200, bool)
    key = jax.random.PRNGKey(3)
    jsim, jfrac = jg.ransac_alignment(jnp.asarray(scene), jnp.asarray(model),
                                      jnp.asarray(valid), inlier_tau=0.02, key=key,
                                      n_hypotheses=1024, with_scale=with_scale)
    tri = torch.tensor(_jax_triplets(valid, key, 1024))
    sim, frac = tg.ransac_from_triplets(torch.tensor(scene), torch.tensor(model),
                                        torch.tensor(valid), tri, inlier_tau=0.02,
                                        with_scale=with_scale)
    np.testing.assert_allclose(sim.R.numpy(), np.asarray(jsim.R), atol=1e-4)
    np.testing.assert_allclose(sim.t.numpy(), np.asarray(jsim.t), atol=1e-4)
    np.testing.assert_allclose(float(sim.s), float(jsim.s), atol=1e-4)
    assert float(frac) == float(jfrac)
    assert _rot_err_deg(sim.R.numpy(), R) < 0.5 and abs(float(sim.s) - s_fac) < 0.01
    np.testing.assert_allclose(sim.t.numpy(), t, atol=0.02)
    # and the port's own draw finds the same pose
    own, own_frac = tg.ransac_alignment(torch.tensor(scene), torch.tensor(model),
                                        torch.tensor(valid), inlier_tau=0.02, seed=3,
                                        n_hypotheses=1024, with_scale=with_scale)
    assert _rot_err_deg(own.R.numpy(), R) < 0.5 and 0.2 < float(own_frac) < 0.35


def test_median_averages_the_two_middle_values():
    """``jnp.median`` of an even count is the mean of its two middle values
    (``torch.median`` gives the lower); the inlier radius rests on it."""
    for n in (6, 7, 1000, 1001):
        x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
        assert float(tg.median(torch.tensor(x))) == float(jnp.median(jnp.asarray(x)))
    x = torch.tensor([1.0, 2.0, 4.0, 8.0])
    assert float(tg.median(x)) == 3.0 and float(torch.median(x)) == 2.0
    assert torch.isnan(tg.median(torch.tensor([1.0, float("nan"), 2.0])))


def test_median_spacing_matches_jax_tau():
    pts = _cow(4)
    d2, _ = knn_pallas(jnp.asarray(pts), jnp.asarray(pts), 2)
    want = jnp.median(jnp.sqrt(jnp.maximum(d2[:, -1], 0.0)))
    got = tg.median_spacing(torch.tensor(pts))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.fixture(scope="module")
def crops():
    """Two overlapping crops of a seeded surface patch (~600 points each),
    the scene crop moved by a 120-degree rotation and a translation."""
    rng = np.random.default_rng(8)
    xy = rng.uniform(-1, 1, (1400, 2))
    z = 0.3 * np.sin(2.5 * xy[:, 0]) * np.cos(1.7 * xy[:, 1]) + 0.2 * xy[:, 0] ** 2
    pts = np.column_stack([xy, z]).astype(np.float32)
    a, b = pts[pts[:, 0] < 0.4], pts[pts[:, 0] > -0.4]
    th = np.deg2rad(120.0)
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    t = np.array([0.3, -0.2, 0.1])
    return a, (b @ R.T + t).astype(np.float32), R.T, -R.T @ t


def test_global_register_recovers_a_known_transform(crops):
    """End to end on the port (its own draw): the pose within 3 degrees and
    0.05 of the truth, as JAX's run on the same crops."""
    a, b, R_true, t_true = crops
    res = tg.global_register(a, b, seed=0, device=CPU)
    want = jg.global_register(a, b, seed=0)
    for sim in (res.transform, want.transform):
        assert _rot_err_deg(np.asarray(sim.R), R_true) < 3.0
        assert np.linalg.norm(np.asarray(sim.t) - t_true) < 0.05
    assert int(res.n_mutual) > 0 and float(res.inlier_fraction) > 0.2
