"""The port's GICP engine and CLI vs the JAX package.

Engine: the wavy surface of ``tests/test_gicp.py``, float64, both engines
fed the same normals of both clouds (from JAX) and, on the grid path, the
same tiles: the same iteration count, points within atol 1e-8, traces
within rtol 1e-6 (atol 1e-18: near-zero last errors sit at the float64
rounding floor).  The covariance algebra against JAX's functions.  CLI:
``--engine gicp --device cpu`` on the cow pairs against the JAX CLI's
fixtures (``tests/fixtures/torch_gicp/``).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_tpu
from icp_tpu.engine import gicp as j_gicp
from icp_tpu.ops.normals import estimate_normals as j_normals
from icp_tpu_torch import ICPConfig, icp_generalized
from icp_tpu_torch.engine.gicp import _inv3_batched, disk_covariances
from icp_tpu_torch.utils.convert import similarity_from_numpy, similarity_to_numpy
from tests.test_point_to_plane import _small_rigid, _wavy_surface
from tests.test_torch_point_to_plane import check_cli_against_fixtures

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "torch_gicp")
GRID = dict(grid_model_tile=128, grid_scene_tile=64)


def _case(seed, n_model=1100, n_scene=800):
    rng = np.random.default_rng(seed)
    model = _wavy_surface(rng, n_model)
    R, t = _small_rigid(rng)
    scene = (model[:n_scene] - t) @ R
    nm = np.array(j_normals(jnp.asarray(model, jnp.float64), k=12))
    ns = np.array(j_normals(jnp.asarray(scene, jnp.float64), k=12))
    return model, scene, nm, ns, R, t


def test_covariance_algebra_matches_jax():
    rng = np.random.default_rng(0)
    n = rng.standard_normal((40, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    for eps in (1e-3, 0.5):
        np.testing.assert_allclose(
            disk_covariances(torch.tensor(n), eps).numpy(),
            np.asarray(j_gicp.disk_covariances(jnp.asarray(n), eps)), rtol=0, atol=1e-15)
    M = rng.standard_normal((50, 3, 3))
    M = M @ M.transpose(0, 2, 1) + 0.1 * np.eye(3)  # SPD
    M[0] = 0.0  # |det| < 1e-30: the adjugate over 1
    M[1] = np.outer([1.0, 2.0, 3.0], [1.0, -1.0, 0.5])  # rank one
    got = _inv3_batched(torch.tensor(M)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_gicp._inv3_batched(jnp.asarray(M))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got[2:], np.linalg.inv(M[2:]), rtol=1e-8, atol=1e-10)
    assert np.isfinite(got[:2]).all()


@pytest.mark.parametrize("nn", ["bcast", "grid"])
def test_engine_matches_jax_float64(nn):
    model, scene, nm, ns, R, t = _case(1)
    extra = GRID if nn == "grid" else {}
    base = dict(max_iter=30, validate_inputs=False, threshold=1e-12, nn_method=nn, **extra)
    jtr = j_gicp.icp_generalized(model, scene, icp_tpu.ICPConfig(dtype=jnp.float64, **base),
                                 model_normals=nm, scene_normals=ns, trace=True)
    tr = icp_generalized(model, scene, ICPConfig(dtype=torch.float64, **base),
                         model_normals=nm, scene_normals=ns, trace=True, device="cpu")
    n = int(tr.result.iters)
    assert n == int(jtr.result.iters) and 1 < n < 30
    np.testing.assert_allclose(tr.result.points.numpy(), np.asarray(jtr.result.points),
                               atol=1e-8)
    np.testing.assert_allclose(tr.errs[:n].numpy(), np.asarray(jtr.errs)[:n],
                               rtol=1e-6, atol=1e-18)
    assert np.isnan(tr.errs[n:].numpy()).all()
    for a, b in zip(similarity_to_numpy(tr.result.transform), jtr.result.transform):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-8)
    np.testing.assert_allclose(tr.result.transform.R.numpy(), R, atol=1e-4)
    np.testing.assert_allclose(tr.result.transform.t.numpy(), t, atol=1e-4)


def test_grid_matches_dense_in_the_port():
    model, scene, nm, ns, _, _ = _case(2)
    base = dict(max_iter=30, dtype=torch.float64, validate_inputs=False, threshold=1e-12)
    dense = icp_generalized(model, scene, ICPConfig(nn_method="bcast", **base),
                            model_normals=nm, scene_normals=ns, device="cpu")
    grid = icp_generalized(model, scene, ICPConfig(nn_method="grid", **GRID, **base),
                           model_normals=nm, scene_normals=ns, device="cpu")
    assert int(grid.iters) == int(dense.iters)
    # the grid carries the model normals as float32 payload
    np.testing.assert_allclose(grid.points.numpy(), dense.points.numpy(), atol=1e-5)


def test_warm_start_and_estimated_normals_match_jax():
    """No normals given: both engines estimate them from the clouds (k=16);
    the warm start rotates the scene covariances before the loop."""
    model, scene, _, _, R, t = _case(3, n_model=700, n_scene=700)
    init = (np.float64(1.0), _small_rigid(np.random.default_rng(4), rot=0.01)[0] @ R,
            0.01 * np.ones(3))
    jinit = icp_tpu.Similarity(*(jnp.asarray(v, jnp.float64) for v in init))
    base = dict(max_iter=25, validate_inputs=False, threshold=1e-12, nn_method="bcast")
    jres = j_gicp.icp_generalized(model, scene, icp_tpu.ICPConfig(dtype=jnp.float64, **base),
                                  init=jinit)
    res = icp_generalized(model, scene, ICPConfig(dtype=torch.float64, **base),
                          init=similarity_from_numpy(init, torch.float64), device="cpu")
    assert int(res.iters) == int(jres.iters)
    np.testing.assert_allclose(res.points.numpy(), np.asarray(jres.points), atol=1e-7)
    np.testing.assert_allclose(res.transform.R.numpy(), R, atol=1e-4)


def test_trace_has_a_nan_tail_and_falls_on_the_kernel_paths():
    model, scene, _, _, _, _ = _case(5, n_model=900, n_scene=700)
    for nn in ("pallas", "grid"):
        cfg = ICPConfig(max_iter=20, nn_method=nn, validate_inputs=False, threshold=1e-9,
                        **GRID)
        tr = icp_generalized(model, scene, cfg, trace=True, device="cpu")
        it = int(tr.result.iters)
        errs = tr.errs.numpy()
        assert errs.shape == (20,) and 1 < it < 20
        assert np.isfinite(errs[:it]).all() and np.isnan(errs[it:]).all()
        assert errs[it - 1] < 1e-9 <= errs[it - 2] and errs[0] > errs[it - 1]


@pytest.mark.parametrize("name,iters", [("cow_tr1", 3), ("cow_tr2", 4)])
def test_cli_gicp_matches_jax_fixtures(tmp_path, name, iters):
    check_cli_against_fixtures(tmp_path, "gicp", FIXDIR, name, iters)


def test_trim_is_not_ported():
    """Trim, which raised ``NotImplementedError`` before it was ported, runs
    as JAX's trimmed GICP (float64, same normals: the same iterations,
    points within atol 1e-8)."""
    model, scene, nm, ns, _, _ = _case(6, n_model=200, n_scene=200)
    base = dict(max_iter=20, trim_fraction=0.1, nn_method="bcast", threshold=1e-12)
    jres = j_gicp.icp_generalized(model, scene, icp_tpu.ICPConfig(dtype=jnp.float64, **base),
                                  model_normals=nm, scene_normals=ns)
    res = icp_generalized(model, scene, ICPConfig(dtype=torch.float64, **base),
                          model_normals=nm, scene_normals=ns, device="cpu")
    assert int(res.iters) == int(jres.iters) >= 2
    np.testing.assert_allclose(res.points.numpy(), np.asarray(jres.points), atol=1e-8)
