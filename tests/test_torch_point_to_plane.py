"""The port's point-to-plane engine and CLI vs the JAX package.

Engine: the wavy surface of ``tests/test_point_to_plane.py``, float64, both
engines fed the same normals (from JAX) and, on the grid path, the same
tiles: the same iteration count, points within atol 1e-8, traces within
rtol 1e-6 (atol 1e-18: near-zero last errors sit at the float64 rounding
floor).  CLI: ``--engine point_to_plane --device cpu`` on the cow pairs
against the JAX CLI's fixtures (``tests/fixtures/torch_p2pl/``): the same
iteration count, the trace within rtol 1e-2 on entries > 1e-6 (float32
coordinates, as ``chip_smoke.TRACE_RTOL``), ``output.txt`` within atol 1e-5
(both printed at 6 significant digits).
"""

import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_tpu
from icp_tpu.engine.point_to_plane import icp_point_to_plane as j_p2pl
from icp_tpu.ops.normals import estimate_normals as j_normals
from icp_tpu_torch import ICPConfig
from icp_tpu_torch.engine.point_to_plane import _rodrigues, icp_point_to_plane
from icp_tpu_torch.io.csv import load_matrix
from icp_tpu_torch.utils.convert import similarity_to_numpy
from tests.conftest import data_path
from tests.test_torch_cli import run_cli

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "torch_p2pl")
_TRACE_RE = re.compile(r"\[ICP\] iteration number (\d+) \| error value = (\S+)")


def _wavy_surface(rng, n):
    xy = rng.uniform(-1, 1, (n, 2))
    return np.column_stack([xy, 0.25 * np.sin(3 * xy[:, 0]) * np.cos(2 * xy[:, 1])])


def _small_rigid(rng, rot=0.05, ts=0.05):
    w = rot * rng.standard_normal(3)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    U, _, Vt = np.linalg.svd(np.eye(3) + K)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R[:, 0] = -R[:, 0]
    return R, ts * rng.standard_normal(3)


def _case(seed=0, n_model=1100, n_scene=800):
    rng = np.random.default_rng(seed)
    model = _wavy_surface(rng, n_model)
    R, t = _small_rigid(rng)
    scene = (model[:n_scene] - t) @ R
    normals = np.asarray(j_normals(jnp.asarray(model, jnp.float64), k=12))
    return model, scene, normals, R, t


GRID = dict(grid_model_tile=128, grid_scene_tile=64)


@pytest.mark.parametrize("nn", ["bcast", "grid"])
def test_engine_matches_jax_float64(nn):
    model, scene, normals, R, t = _case()
    extra = GRID if nn == "grid" else {}
    base = dict(max_iter=25, validate_inputs=False, threshold=1e-12, nn_method=nn, **extra)
    jtr = j_p2pl(model, scene, icp_tpu.ICPConfig(dtype=jnp.float64, **base),
                 normals=normals, trace=True)
    tr = icp_point_to_plane(model, scene, ICPConfig(dtype=torch.float64, **base),
                            normals=normals, trace=True, device="cpu")
    n = int(tr.result.iters)
    assert n == int(jtr.result.iters) and 2 < n < 25
    np.testing.assert_allclose(tr.result.points.numpy(), np.asarray(jtr.result.points),
                               atol=1e-8)
    np.testing.assert_allclose(tr.errs[:n].numpy(), np.asarray(jtr.errs)[:n],
                               rtol=1e-6, atol=1e-18)
    for a, b in zip(similarity_to_numpy(tr.result.transform), jtr.result.transform):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-8)
    np.testing.assert_allclose(tr.result.transform.R.numpy(), R, atol=1e-4)
    np.testing.assert_allclose(tr.result.transform.t.numpy(), t, atol=1e-4)


def test_grid_matches_dense_in_the_port():
    model, scene, normals, _, _ = _case(seed=1)
    base = dict(max_iter=25, dtype=torch.float64, validate_inputs=False, threshold=1e-14)
    dense = icp_point_to_plane(model, scene, ICPConfig(nn_method="bcast", **base),
                               normals=normals, device="cpu")
    grid = icp_point_to_plane(model, scene, ICPConfig(nn_method="grid", **GRID, **base),
                              normals=normals, device="cpu")
    assert int(grid.iters) == int(dense.iters)
    # the grid carries the normals as float32 payload
    np.testing.assert_allclose(grid.points.numpy(), dense.points.numpy(), atol=1e-5)


@pytest.mark.parametrize("nn", ["bcast", "pallas", "grid"])
def test_trace_has_a_nan_tail_and_falls(nn):
    model, scene, _, _, _ = _case(seed=2, n_model=900, n_scene=700)
    cfg = ICPConfig(max_iter=20, nn_method=nn, validate_inputs=False, threshold=1e-9, **GRID)
    tr = icp_point_to_plane(model, scene, cfg, trace=True, device="cpu")
    it = int(tr.result.iters)
    errs = tr.errs.numpy()
    assert errs.shape == (20,) and 1 < it < 20
    assert np.isfinite(errs[:it]).all() and np.isnan(errs[it:]).all()
    assert errs[it - 1] < 1e-9 <= errs[it - 2] and errs[0] > errs[it - 1]
    assert float(tr.result.err) == pytest.approx(float(errs[it - 1]))


def test_estimated_normals_and_warm_start_match_jax():
    """No normals given: both engines estimate them from the model (k=16)."""
    model, scene, _, _, _ = _case(seed=3, n_model=700, n_scene=700)
    rng = np.random.default_rng(4)
    init = (np.float64(1.0), _small_rigid(rng, rot=0.01)[0], 0.01 * rng.standard_normal(3))
    jinit = icp_tpu.Similarity(*(jnp.asarray(v, jnp.float64) for v in init))
    base = dict(max_iter=25, validate_inputs=False, threshold=1e-12, nn_method="bcast")
    jres = j_p2pl(model, scene, icp_tpu.ICPConfig(dtype=jnp.float64, **base), init=jinit)
    res = icp_point_to_plane(model, scene, ICPConfig(dtype=torch.float64, **base),
                             init=init, device="cpu")
    assert int(res.iters) == int(jres.iters)
    np.testing.assert_allclose(res.points.numpy(), np.asarray(jres.points), atol=1e-7)


def test_rodrigues_matches_jax():
    from icp_tpu.engine.point_to_plane import _rodrigues as j_rod

    for w in ([0.1, -0.2, 0.3], [1e-14, 0.0, 0.0], [0.0, 0.0, 0.0], [2.0, 0.5, -1.0]):
        want = np.asarray(j_rod(jnp.asarray(w, jnp.float64)))
        got = _rodrigues(torch.tensor(w, dtype=torch.float64)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-15)


def test_options_not_ported_and_default_device(monkeypatch):
    """Trim, which raised ``NotImplementedError`` before it was ported, runs
    as JAX's trimmed point-to-plane (float64, same normals: the same
    iterations, points within atol 1e-8); the input check and the card
    default stay."""
    model, scene, normals, _, _ = _case(seed=5, n_model=200, n_scene=200)
    base = dict(max_iter=20, trim_fraction=0.1, nn_method="bcast", threshold=1e-12)
    jres = j_p2pl(model, scene, icp_tpu.ICPConfig(dtype=jnp.float64, **base),
                  normals=jnp.asarray(normals))
    res = icp_point_to_plane(model, scene, ICPConfig(dtype=torch.float64, **base),
                             normals=normals, device="cpu")
    assert int(res.iters) == int(jres.iters) >= 2
    np.testing.assert_allclose(res.points.numpy(), np.asarray(jres.points), atol=1e-8)
    with pytest.raises(ValueError, match="same number"):
        icp_point_to_plane(model, scene[:100], ICPConfig(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        icp_point_to_plane(model, scene)


def _fixture_trace(fixdir, name):
    with open(os.path.join(fixdir, f"{name}_stderr.txt")) as f:
        return [float(e) for _, e in _TRACE_RE.findall(f.read())]


def check_cli_against_fixtures(tmp_path, engine, fixdir, name, iters, extra=(), prefix=""):
    """``--engine engine --device cpu`` (and ``extra`` flags) on cow_ref +
    ``name`` (30 iterations) against the JAX CLI's trace and ``output.txt``
    in ``fixdir`` (files ``{prefix}{name}_*``)."""
    r = run_cli([data_path("cow_ref.txt"), data_path(f"{name}.txt"), "30",
                 "--engine", engine, "--device", "cpu", *extra], tmp_path)
    assert r.returncode == 0, r.stderr
    pairs = _TRACE_RE.findall(r.stderr)
    assert [int(i) for i, _ in pairs] == list(range(iters))
    got = np.array([float(e) for _, e in pairs])
    want = np.array(_fixture_trace(fixdir, prefix + name))
    assert len(want) == iters
    big = want > 1e-6
    np.testing.assert_allclose(got[big], want[big], rtol=1e-2)
    assert np.all(got[~big] < 1e-5)  # below the convergence threshold, as JAX
    np.testing.assert_allclose(load_matrix(str(tmp_path / "output.txt")),
                               load_matrix(os.path.join(fixdir, f"{prefix}{name}_output.txt")),
                               atol=1e-5)


@pytest.mark.parametrize("name,iters", [("cow_tr1", 3), ("cow_tr2", 6)])
def test_cli_point_to_plane_matches_jax_fixtures(tmp_path, name, iters):
    check_cli_against_fixtures(tmp_path, "point_to_plane", FIXDIR, name, iters)


# (engine, fixture folder, iterations, extra flags, fixture prefix): each
# engine's --sharded run (world size 1) on cow_tr1 against the fixtures of
# its unsharded CLI test
SHARDED_CLI = [("point_to_point", "reference", 7, [], ""),
               ("point_to_plane", "torch_p2pl", 3, [], ""),
               ("symmetric", "torch_sym", 3, [], ""),
               ("gicp", "torch_gicp", 3, [], ""),
               ("point_to_point", "torch_trim", 8, ["--trim", "0.1"], "point_to_point_")]


@pytest.mark.parametrize("engine,folder,iters,extra,prefix", SHARDED_CLI,
                         ids=[f"{e}-{f}" for e, f, _, _, _ in SHARDED_CLI])
def test_cli_sharded_matches_fixtures(tmp_path, engine, folder, iters, extra, prefix):
    """``--sharded`` runs every engine (``parallel/sharded.py`` on a world-1
    gloo group) with the unsharded run's iterations, trace and output."""
    check_cli_against_fixtures(tmp_path, engine, os.path.join(os.path.dirname(FIXDIR), folder),
                               "cow_tr1", iters, extra=["--sharded", *extra], prefix=prefix)


def test_p2pl_error_is_the_plain_mean_of_the_plane_residual():
    model, scene, normals, _, _ = _case(seed=6, n_model=400, n_scene=400)
    cfg = ICPConfig(max_iter=1, dtype=torch.float64, nn_method="bcast",
                    validate_inputs=False, threshold=-math.inf)
    res = icp_point_to_plane(model, scene, cfg, normals=normals, device="cpu")
    p = res.points.numpy()
    idx = ((scene[:, None] - model[None]) ** 2).sum(-1).argmin(1)  # first iteration's NN
    want = np.mean(np.sum(normals[idx] * (p - model[idx]), axis=1) ** 2)
    assert float(res.err) == pytest.approx(want, rel=1e-9)
