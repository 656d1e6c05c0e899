"""The port's symmetric engine and CLI vs the JAX package.

Engine: the curved surface of ``tests/test_symmetric.py``, float64, both
engines fed the same normals of both clouds (from JAX) and, on the grid
path, the same tiles: the same iteration count, points within atol 1e-8,
traces within rtol 1e-6 (atol 1e-18: near-zero last errors sit at the
float64 rounding floor).  CLI: ``--engine symmetric --device cpu`` on the cow
pairs against the JAX CLI's fixtures (``tests/fixtures/torch_sym/``), with
the tolerances of ``test_torch_point_to_plane.py``.  ``nn_method="bf16"``
reaches K9's plain version through ``ops/distance`` in every engine.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_tpu
from icp_tpu.engine.symmetric import icp_symmetric as j_sym
from icp_tpu.ops.normals import estimate_normals as j_normals
from icp_tpu_torch import ICPConfig, icp_symmetric
from icp_tpu_torch.engine.plane import ENGINES, run_engine
from icp_tpu_torch.kernels import nn_bf16
from icp_tpu_torch.utils.convert import similarity_from_numpy, similarity_to_numpy
from tests.test_symmetric import _rigid, _surface
from tests.test_torch_point_to_plane import check_cli_against_fixtures

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "torch_sym")
GRID = dict(grid_model_tile=128, grid_scene_tile=64)


def _case(seed, n_model=1100, n_scene=800, angle=0.15):
    rng = np.random.default_rng(seed)
    model = _surface(rng, n=n_model)
    R, t = _rigid(rng, angle)
    scene = (model @ R.T + t)[:n_scene]
    nm = np.asarray(j_normals(jnp.asarray(model, jnp.float64), k=12))
    ns = np.asarray(j_normals(jnp.asarray(scene, jnp.float64), k=12))
    return model, scene, nm, ns, R, t


@pytest.mark.parametrize("nn", ["bcast", "grid"])
def test_engine_matches_jax_float64(nn):
    model, scene, nm, ns, R, _ = _case(37)
    extra = GRID if nn == "grid" else {}
    base = dict(max_iter=30, validate_inputs=False, threshold=1e-12, nn_method=nn, **extra)
    jtr = j_sym(model, scene, icp_tpu.ICPConfig(dtype=jnp.float64, **base),
                normals=nm, scene_normals=ns, trace=True)
    tr = icp_symmetric(model, scene, ICPConfig(dtype=torch.float64, **base),
                       normals=nm, scene_normals=ns, trace=True, device="cpu")
    n = int(tr.result.iters)
    assert n == int(jtr.result.iters) and 2 < n < 30
    np.testing.assert_allclose(tr.result.points.numpy(), np.asarray(jtr.result.points),
                               atol=1e-8)
    np.testing.assert_allclose(tr.errs[:n].numpy(), np.asarray(jtr.errs)[:n],
                               rtol=1e-6, atol=1e-18)
    assert np.isnan(tr.errs[n:].numpy()).all()
    for a, b in zip(similarity_to_numpy(tr.result.transform), jtr.result.transform):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-8)
    np.testing.assert_allclose(tr.result.transform.R.numpy(), R.T, atol=1e-6)


def test_grid_matches_dense_in_the_port():
    model, scene, nm, ns, _, _ = _case(41)
    base = dict(max_iter=30, dtype=torch.float64, validate_inputs=False, threshold=1e-14)
    dense = icp_symmetric(model, scene, ICPConfig(nn_method="bcast", **base),
                          normals=nm, scene_normals=ns, device="cpu")
    grid = icp_symmetric(model, scene, ICPConfig(nn_method="grid", **GRID, **base),
                         normals=nm, scene_normals=ns, device="cpu")
    assert int(grid.iters) == int(dense.iters)
    # the grid carries the model normals as float32 payload
    np.testing.assert_allclose(grid.points.numpy(), dense.points.numpy(), atol=1e-5)


def test_sign_flipped_model_normals_are_canonicalised():
    model, scene, nm, ns, _, _ = _case(11, n_model=600, n_scene=600, angle=0.1)
    cfg = ICPConfig(max_iter=40, dtype=torch.float64, nn_method="bcast",
                    validate_inputs=False, threshold=1e-12)
    a = icp_symmetric(model, scene, cfg, normals=nm, scene_normals=ns, device="cpu")
    b = icp_symmetric(model, scene, cfg, normals=-nm, scene_normals=ns, device="cpu")
    assert int(a.iters) == int(b.iters)
    np.testing.assert_allclose(a.points.numpy(), b.points.numpy(), atol=1e-10)
    jb = j_sym(model, scene, icp_tpu.ICPConfig(dtype=jnp.float64, max_iter=40,
                                               nn_method="bcast", validate_inputs=False,
                                               threshold=1e-12),
               normals=-nm, scene_normals=ns)
    np.testing.assert_allclose(b.points.numpy(), np.asarray(jb.points), atol=1e-8)


def test_warm_start_and_estimated_normals_match_jax():
    """No normals given: both engines estimate them from the clouds (k=16)."""
    model, scene, _, _, R, t = _case(19, n_model=700, n_scene=700, angle=0.3)
    init = (np.float64(1.0), R.T, -R.T @ t + 0.01)
    jinit = icp_tpu.Similarity(*(jnp.asarray(v, jnp.float64) for v in init))
    base = dict(max_iter=20, validate_inputs=False, threshold=1e-12, nn_method="bcast")
    jres = j_sym(model, scene, icp_tpu.ICPConfig(dtype=jnp.float64, **base), init=jinit)
    res = icp_symmetric(model, scene, ICPConfig(dtype=torch.float64, **base),
                        init=similarity_from_numpy(init, torch.float64), device="cpu")
    assert int(res.iters) == int(jres.iters) and int(res.iters) <= 4
    np.testing.assert_allclose(res.points.numpy(), np.asarray(jres.points), atol=1e-7)
    T = res.transform
    np.testing.assert_allclose(scene @ T.R.numpy().T + T.t.numpy(), res.points.numpy(),
                               atol=1e-9)


@pytest.mark.parametrize("engine", ENGINES)
def test_bf16_reaches_the_prefilter_in_every_engine(monkeypatch, engine):
    """``nn_method="bf16"`` goes through ``ops/distance`` to K9 (its plain
    version on the CPU), once per launched iteration, and still registers
    the exact-transform surface of ``test_symmetric.py:297``."""
    calls = []

    def spy(scene, model):
        calls.append(scene.shape[0])
        return plain(scene, model)

    plain = nn_bf16.nn_bf16_plain
    monkeypatch.setattr(nn_bf16, "nn_bf16_plain", spy)
    rng = np.random.default_rng(43)
    model = _surface(rng, n=500)
    R, t = _rigid(rng, 0.1)
    scene = model @ R.T + t
    cfg = ICPConfig(max_iter=40, threshold=1e-10, nn_method="bf16", validate_inputs=False)
    res = run_engine(engine, model.astype(np.float32), scene.astype(np.float32), cfg,
                     device="cpu")
    iters = int(res.iters)
    # the gated loops launch whole chunks of 8; icp's host loop stops at once
    steps = iters if engine == "point_to_point" else min(40, 8 * math.ceil(iters / 8))
    assert calls == [500] * steps and iters >= 1
    if engine == "symmetric":
        dev = np.linalg.norm(res.points.numpy() - model.astype(np.float32), axis=1)
        assert np.median(dev) < 1e-2


@pytest.mark.parametrize("name,iters", [("cow_tr1", 3), ("cow_tr2", 5)])
def test_cli_symmetric_matches_jax_fixtures(tmp_path, name, iters):
    check_cli_against_fixtures(tmp_path, "symmetric", FIXDIR, name, iters)


def test_trim_is_not_ported():
    """Trim, which raised ``NotImplementedError`` before it was ported, runs
    as JAX's trimmed symmetric engine (float64, same normals: the same
    iterations, points within atol 1e-8)."""
    model, scene, nm, ns, _, _ = _case(5, n_model=200, n_scene=200)
    base = dict(max_iter=20, trim_fraction=0.1, nn_method="bcast", threshold=1e-12)
    jres = j_sym(model, scene, icp_tpu.ICPConfig(dtype=jnp.float64, **base), normals=nm,
                 scene_normals=ns)
    res = icp_symmetric(model, scene, ICPConfig(dtype=torch.float64, **base), normals=nm,
                        scene_normals=ns, device="cpu")
    assert int(res.iters) == int(jres.iters) >= 2
    np.testing.assert_allclose(res.points.numpy(), np.asarray(jres.points), atol=1e-8)
