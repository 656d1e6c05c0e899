"""The port's SLAM layer (``slam/pairwise.py``, ``slam/pose_graph.py``,
``slam/closure.py``) against the JAX package's, the counterparts of
``tests/test_slam.py``, ``tests/test_multiscale.py`` and
``tests/test_closure.py``.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: float64 registrations within 1e-6 of JAX's (the same float64
solves; the truth within JAX's tests' bounds), float32 chains and pose
graphs within 1e-4 (float32 sums in another order), the planted
closure's score within 0.02 (RANSAC draws its triplets from each
package's own generator; the disjoint pairs are held to the threshold).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_tpu import ICPConfig as JConfig
from icp_tpu.ops.alignment import Similarity as JSim
from icp_tpu.ops.transform import identity_similarity as jidentity
from icp_tpu.slam import closure as jcl
from icp_tpu.slam import pairwise as jpw
from icp_tpu.slam import pose_graph as jpg
from icp_tpu_torch import ICPConfig
from icp_tpu_torch.ops.alignment import Similarity
from icp_tpu_torch.slam import closure as tcl
from icp_tpu_torch.slam import pairwise as tpw
from icp_tpu_torch.slam import pose_graph as tpg

CPU = "cpu"


def _rot(rng):
    q, r = np.linalg.qr(rng.standard_normal((3, 3)))
    q = q @ np.diag(np.sign(np.diag(r)))
    return q if np.linalg.det(q) > 0 else -q


def _rot_z(th):
    return np.array([[np.cos(th), -np.sin(th), 0.0], [np.sin(th), np.cos(th), 0.0],
                     [0.0, 0.0, 1.0]])


def _small_rot(rng, scale):
    w = scale * rng.standard_normal(3)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    U, _, Vt = np.linalg.svd(np.eye(3) + K)
    R = U @ Vt
    return R if np.linalg.det(R) > 0 else -R


def _observe(world, R, t):
    """The world seen from pose (R, t): R^T (x - t)."""
    return (world - t) @ R


def _cfgs(**kw):
    return ICPConfig(**kw), JConfig(**{k: (jnp.float64 if v is torch.float64 else
                                          jnp.float32 if v is torch.float32 else v)
                                       for k, v in kw.items()})


F64 = dict(max_iter=60, dtype=torch.float64, nn_method="bcast", solver="eigh",
           with_scale=False, validate_inputs=False)


def _close(got, want, atol):
    """The port's Similarity (CPU tensors) against JAX's, R and t."""
    for f in ("R", "t"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   atol=atol)


# --------------------------------------------------------------------------
# pairwise
# --------------------------------------------------------------------------

def test_register_pair_unequal_counts_matches_jax():
    rng = np.random.default_rng(1)
    world = rng.standard_normal((400, 3)) * 2.0
    R, t = _small_rot(rng, 0.15), 0.2 * rng.standard_normal(3)
    scene = _observe(world[:350], R, t)
    cfg, jcfg = _cfgs(**F64)
    pr = tpw.register_pair(world, scene, cfg, device=CPU)
    jpr = jpw.register_pair(world, scene, jcfg)
    _close(pr.transform, jpr.transform, 1e-6)
    np.testing.assert_allclose(pr.transform.R.numpy(), R, atol=1e-5)
    np.testing.assert_allclose(pr.transform.t.numpy(), t, atol=1e-5)
    assert pr.iters == jpr.iters


def test_chain_world_poses_match_jax():
    rng = np.random.default_rng(2)
    world = rng.standard_normal((500, 3)) * 2.0
    Rs, ts = [np.eye(3)], [np.zeros(3)]
    for _ in range(3):
        dR, dt = _small_rot(rng, 0.15), 0.2 * rng.standard_normal(3)
        Rs.append(Rs[-1] @ dR)
        ts.append(Rs[-2] @ dt + ts[-1])
    clouds = [_observe(world, R, t) for R, t in zip(Rs, ts)]
    cfg, jcfg = _cfgs(**dict(F64, max_iter=80))
    poses = tpw.chain_to_world_poses(tpw.register_chain(clouds, cfg, device=CPU))
    jposes = jpw.chain_to_world_poses(jpw.register_chain(clouds, jcfg))
    for p, jp, R, t in zip(poses, jposes, Rs, ts):
        _close(p, jp, 1e-6)
        np.testing.assert_allclose(p.R.numpy(), R, atol=1e-4)
        np.testing.assert_allclose(p.t.numpy(), t, atol=1e-4)


def test_pca_init_and_multiscale_match_jax():
    """A spiral rotated 50 degrees: ICP from identity stalls, the PCA start
    with levels (4, 1) lands on the truth, as in JAX."""
    rng = np.random.default_rng(3)
    s = np.linspace(0, 4 * np.pi, 800)
    world = np.stack([np.cos(s) * (1 + 0.2 * s), np.sin(s) * (1 + 0.2 * s), 0.3 * s], 1)
    world += 0.005 * rng.standard_normal(world.shape)
    R, t = _rot_z(np.deg2rad(50.0)), np.array([0.5, -0.3, 0.2])
    scene = _observe(world, R, t)
    init = tpw.initialize_pca(world, scene)
    jinit = jpw.initialize_pca(world, scene)
    _close(init, jinit, 1e-6)
    cfg, jcfg = _cfgs(**F64)
    vanilla = tpw.register_pair(world, scene, cfg, device=CPU)
    pca = tpw.register_pair(world, scene, cfg, init="pca", multiscale=(4, 1), device=CPU)
    jpca = jpw.register_pair(world, scene, jcfg, init="pca", multiscale=(4, 1))
    assert np.abs(vanilla.transform.R.numpy() - R).max() > 0.05
    _close(pca.transform, jpca.transform, 1e-6)
    np.testing.assert_allclose(pca.transform.R.numpy(), R, atol=1e-3)
    np.testing.assert_allclose(pca.transform.t.numpy(), t, atol=5e-3)
    # the levels compose: the result maps the scene onto the model
    sim = pca.transform
    moved = scene @ (sim.s.item() * sim.R.numpy()).T + sim.t.numpy()
    assert np.sqrt(((moved - world) ** 2).sum(1).mean()) < 0.02


@pytest.mark.parametrize("engine", ["point_to_point", "point_to_plane"])
def test_bucketed_multiscale_chain_matches_jax(engine):
    """An unequal-count float32 chain, auto-bucketed (every pair padded to
    the chain's largest bucket of each level), levels (2, 1): each pair's
    transform within 1e-4 of JAX's and its iterations equal."""
    rng = np.random.default_rng(4)
    s = rng.uniform(-1, 1, (900, 2))
    surf = np.column_stack([s, 0.3 * np.sin(3 * s[:, 0]) * np.cos(2 * s[:, 1])])
    clouds = []
    for k, n in enumerate((700, 560, 640)):
        sel = np.sort(rng.choice(900, n, replace=False))
        clouds.append(_observe(surf[sel], _rot_z(0.03 * k), np.array([0.02 * k, 0, 0]))
                      .astype(np.float32))
    kw = dict(max_iter=30, dtype=torch.float32, nn_method="bcast", solver="eigh",
              with_scale=False, validate_inputs=False, trim_fraction=0.1)
    cfg, jcfg = _cfgs(**kw)
    pairs = tpw.register_chain(clouds, cfg, multiscale=(2, 1), engine=engine, device=CPU)
    jpairs = jpw.register_chain(clouds, jcfg, multiscale=(2, 1), engine=engine)
    for pr, jpr in zip(pairs, jpairs):
        _close(pr.transform, jpr.transform, 1e-4)
        assert pr.iters == jpr.iters
        np.testing.assert_allclose(pr.err, jpr.err, rtol=1e-3, atol=1e-9)


# --------------------------------------------------------------------------
# pose graph and bundle adjustment
# --------------------------------------------------------------------------

def _jsim(R, t):
    return JSim(jnp.asarray(1.0, jnp.float32), jnp.asarray(R, jnp.float32),
                jnp.asarray(t, jnp.float32))


def _tsim(R, t):
    return Similarity(torch.tensor(1.0), torch.tensor(R, dtype=torch.float32),
                      torch.tensor(t, dtype=torch.float32))


def _graph_problem(rng, n, rot_scale, t_scale):
    """True world poses (R, t) of a chain of ``n`` poses."""
    Rs, ts = [np.eye(3, dtype=np.float32)], [np.zeros(3, np.float32)]
    for _ in range(n - 1):
        dR = _small_rot(rng, rot_scale).astype(np.float32)
        dt = (t_scale * rng.standard_normal(3)).astype(np.float32)
        ts.append(Rs[-1] @ dt + ts[-1])
        Rs.append(Rs[-1] @ dR)
    return Rs, ts


def _edge(Rs, ts, i, j):
    return Rs[i].T @ Rs[j], Rs[i].T @ (ts[j] - ts[i])


def test_pose_params_roundtrip():
    rng = np.random.default_rng(5)
    poses = [_tsim(np.eye(3), np.zeros(3))] + [_tsim(_rot(rng), rng.standard_normal(3))
                                               for _ in range(3)]
    theta = tpg.poses_to_params(poses)
    jtheta = jpg.poses_to_params([_jsim(p.R.numpy(), p.t.numpy()) for p in poses])
    np.testing.assert_array_equal(theta.numpy(), np.asarray(jtheta))
    for p, b in zip(poses, tpg.params_to_poses(theta)):
        np.testing.assert_allclose(b.R.numpy(), p.R.numpy(), atol=1e-6)
        np.testing.assert_allclose(b.t.numpy(), p.t.numpy(), atol=1e-6)


def test_pose_graph_closes_loop_matches_jax():
    rng = np.random.default_rng(6)
    Rs, ts = _graph_problem(rng, 4, 0.4, 1.0)
    pairs = [(0, 1), (1, 2), (2, 3), (0, 3)]
    edges = [tpg.PoseEdge(i, j, *map(torch.tensor, _edge(Rs, ts, i, j))) for i, j in pairs]
    jedges = [jpg.PoseEdge(i, j, *map(jnp.asarray, _edge(Rs, ts, i, j))) for i, j in pairs]
    noise = [np.zeros(3)] + [0.3 * rng.standard_normal(3) for _ in range(3)]
    init = [_tsim(R, t + d) for R, t, d in zip(Rs, ts, noise)]
    jinit = [_jsim(R, t + d) for R, t, d in zip(Rs, ts, noise)]
    opt, cost = tpg.optimize_pose_graph(init, edges, n_iters=15)
    jopt, jcost = jpg.optimize_pose_graph(jinit, jedges, n_iters=15)
    assert cost < 1e-8 and jcost < 1e-8
    for o, jo, R, t in zip(opt, jopt, Rs, ts):
        _close(o, jo, 1e-4)
        np.testing.assert_allclose(o.t.numpy(), t, atol=1e-3)
        np.testing.assert_allclose(o.R.numpy(), R, atol=1e-3)


def test_pose_graph_robust_rejects_outlier_edge():
    """Chain + three closures and one garbage edge, the init chained
    through it: the robust kernel recovers the truth, plain least squares
    does not, and both match JAX's runs."""
    rng = np.random.default_rng(11)
    Rs, ts = _graph_problem(rng, 5, 0.4, 1.0)
    bad = (_rot(rng).astype(np.float32), np.array([3.0, -2.0, 1.0], np.float32))
    pairs = [(0, 1), (1, 2), (2, 3), (3, 4), (0, 2), (1, 3), (2, 4)]
    meas = [bad if (i, j) == (1, 2) else _edge(Rs, ts, i, j) for i, j in pairs]
    init_R, init_t = list(Rs[:2]), list(ts[:2])
    for R_ij, t_ij in (meas[1], meas[2], meas[3]):
        init_t.append(init_t[-1] + init_R[-1] @ t_ij)
        init_R.append(init_R[-1] @ R_ij)
    edges = [tpg.PoseEdge(i, j, torch.tensor(R), torch.tensor(t)) for (i, j), (R, t) in
             zip(pairs, meas)]
    jedges = [jpg.PoseEdge(i, j, jnp.asarray(R), jnp.asarray(t)) for (i, j), (R, t) in
              zip(pairs, meas)]
    init = [_tsim(R, t) for R, t in zip(init_R, init_t)]
    jinit = [_jsim(R, t) for R, t in zip(init_R, init_t)]

    def max_t_err(poses):
        return max(float(np.linalg.norm(np.asarray(p.t) - t)) for p, t in zip(poses, ts))

    plain, _ = tpg.optimize_pose_graph(init, edges, n_iters=25)
    robust, _ = tpg.optimize_pose_graph(init, edges, n_iters=25, robust_phi=1.0)
    jrobust, _ = jpg.optimize_pose_graph(jinit, jedges, n_iters=25, robust_phi=1.0)
    assert max_t_err(robust) < 1e-2 and max_t_err(plain) > 5 * max_t_err(robust)
    for o, jo, R in zip(robust, jrobust, Rs):
        _close(o, jo, 1e-4)
        np.testing.assert_allclose(o.R.numpy(), R, atol=1e-2)


def test_bundle_adjust_matches_jax():
    rng = np.random.default_rng(7)
    Rs = [np.eye(3, dtype=np.float32)] + [_rot(rng).astype(np.float32) for _ in range(2)]
    ts = [np.zeros(3, np.float32)] + [rng.standard_normal(3).astype(np.float32)
                                      for _ in range(2)]
    world = rng.standard_normal((64, 3)).astype(np.float32)
    frames = [_observe(world, R, t).astype(np.float32) for R, t in zip(Rs, ts)]
    corr = [(0, 1, frames[0], frames[1]), (1, 2, frames[1], frames[2]),
            (0, 2, frames[0], frames[2])]
    noise = [np.zeros(3)] + [0.2 * rng.standard_normal(3) for _ in range(2)]
    opt, cost = tpg.bundle_adjust([_tsim(R, t + d) for R, t, d in zip(Rs, ts, noise)], corr,
                                  n_iters=10)
    jopt, jcost = jpg.bundle_adjust([_jsim(R, t + d) for R, t, d in zip(Rs, ts, noise)],
                                    corr, n_iters=10)
    assert cost < 1e-6 and jcost < 1e-6
    for o, jo, R, t in zip(opt, jopt, Rs, ts):
        _close(o, jo, 1e-4)
        np.testing.assert_allclose(o.t.numpy(), t, atol=1e-3)
        np.testing.assert_allclose(o.R.numpy(), R, atol=1e-3)


# --------------------------------------------------------------------------
# closures
# --------------------------------------------------------------------------

def test_subsample_fixed_picks_jax_rows():
    """numpy's ``default_rng`` in both packages: the same rows."""
    pts = np.random.default_rng(8).standard_normal((1000, 3)).astype(np.float32)
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for n_out in (256, 256, 2000):
        got, want = tcl._subsample_fixed(pts, n_out, a), jcl._subsample_fixed(pts, n_out, b)
        np.testing.assert_array_equal(got, want)
    assert len(np.unique(tcl._subsample_fixed(pts, 256, a), axis=0)) == 256


def test_chain_edges_from_pairs_flags_outlier():
    def pr(err):
        return tpw.PairwiseResult(transform=_tsim(np.eye(3), np.zeros(3)), err=err, iters=5)

    def jpr(err):
        return jpw.PairwiseResult(transform=jidentity(), err=err, iters=5)

    errs = [2e-7, 8e-8, 3e-2, 1e-7]
    edges, suspects = tcl.chain_edges_from_pairs([pr(e) for e in errs])
    jedges, jsuspects = jcl.chain_edges_from_pairs([jpr(e) for e in errs])
    assert suspects == jsuspects == [2]
    assert [e.weight for e in edges] == [e.weight for e in jedges] == [1.0, 1.0, 1e-3, 1.0]
    assert [(e.i, e.j) for e in edges] == [(0, 1), (1, 2), (2, 3), (3, 4)]
    assert tcl.chain_edges_from_pairs([pr(0.0)] * 3)[1] == []


@pytest.fixture(scope="module")
def surface_scans():
    """Four synthetic scans of a seeded surface: 0/1/2 a sliding window along
    x (adjacent overlaps only), 3 = scan 0 under a rigid pose (the planted
    closure (0, 3))."""
    rng = np.random.default_rng(9)
    xy = rng.uniform(-1, 1, (3000, 2)) * np.array([2.0, 1.0])
    z = 0.3 * np.sin(2.0 * xy[:, 0]) * np.cos(2.5 * xy[:, 1]) + 0.15 * xy[:, 1] ** 2
    surf = np.column_stack([xy, z]).astype(np.float32)

    def crop(a, b):
        return surf[(surf[:, 0] >= -2 + 4 * a) & (surf[:, 0] <= -2 + 4 * b)]

    R, t = _rot(rng).astype(np.float32), np.array([2.0, -1.0, 0.5], np.float32)
    scans = [crop(0.0, 0.45), crop(0.25, 0.70), crop(0.50, 0.95), crop(0.0, 0.45) @ R.T + t]
    return scans, R, t


def test_detect_and_verify_closures_match_jax(surface_scans):
    """The planted closure is found by both packages with inlier fractions
    within 0.02 (0.2985 both); the disjoint pairs, where RANSAC fits
    noise and a few mutual matches differ (features within the
    ``test_torch_global_reg`` bounds), stay below the default threshold of
    0.15 in both, their mutual counts within 5%; the coarse pose is the
    planted one within 10 degrees, and the feature verification of the
    true pose matches JAX's."""
    scans, R, t = surface_scans
    cands = tcl.detect_loop_closures(scans, max_points=512, inlier_min=0.0, seed=1, device=CPU)
    jcands = jcl.detect_loop_closures(scans, max_points=512, inlier_min=0.0, seed=1)
    by, jby = {(c.i, c.j): c for c in cands}, {(c.i, c.j): c for c in jcands}
    assert set(by) == set(jby) == {(0, 2), (0, 3), (1, 3)}
    assert cands[0] == by[(0, 3)] and by[(0, 3)].inlier_fraction > 0.25
    assert abs(by[(0, 3)].inlier_fraction - jby[(0, 3)].inlier_fraction) <= 0.02
    for p in ((0, 2), (1, 3)):
        assert by[p].inlier_fraction < 0.15 and jby[p].inlier_fraction < 0.15
    for p in by:
        assert abs(by[p].n_mutual - jby[p].n_mutual) <= 0.05 * jby[p].n_mutual, p
    Rg = by[(0, 3)].transform.R.numpy()
    assert np.rad2deg(np.arccos(np.clip((np.trace(Rg @ R) - 1.0) / 2.0, -1, 1))) < 10.0
    true_inv = _tsim(R.T, -R.T @ t)
    frac = tcl.verified_inlier_fraction(scans[0], scans[3], true_inv, device=CPU)
    jfrac = jcl.verified_inlier_fraction(scans[0], scans[3], _jsim(R.T, -R.T @ t))
    assert frac > 0.8 and abs(frac - jfrac) <= 0.02
    ident = _tsim(np.eye(3), np.zeros(3))
    assert tcl.verified_inlier_fraction(scans[0], scans[3], ident, device=CPU) < 0.05
    assert tcl.overlap_fraction(scans[0], scans[3], true_inv, device=CPU) > 0.9


def test_refine_closures_gates_a_false_candidate(surface_scans):
    """ICP refinement keeps the true closure (error under 1e-4, within a
    degree of the planted pose) and drops a junk candidate by its error."""
    scans, R, t = surface_scans
    good = tcl.ClosureCandidate(0, 3, _tsim(R.T, -R.T @ t + 0.01), 0.5, 10)
    fake = tcl.ClosureCandidate(0, 2, _tsim(np.eye(3), np.zeros(3)), 0.99, 1)
    cfg = ICPConfig(max_iter=40, nn_method="bcast", solver="eigh", with_scale=False,
                    validate_inputs=False, trim_fraction=0.3)
    edges, results = tcl.refine_closures(scans, [good, fake], cfg, multiscale=(4, 1),
                                         max_err=1e-4, device=CPU)
    assert [(e.i, e.j) for e in edges] == [(0, 3)] and float(results[0].err) < 1e-4
    c = (np.trace(edges[0].R.numpy() @ R) - 1.0) / 2.0
    assert np.rad2deg(np.arccos(np.clip(c, -1, 1))) < 1.0
