"""Bucket padding in the port (``ops/padding.py``) against the JAX package
(``tests/test_padding.py``).

  * The host functions give JAX's buckets, sentinels and quanta;
    ``replica_fill`` and ``valid_mask`` equal JAX's bit for bit.
  * Bucket-padded runs (``scene_n``/``model_n``) equal the exact-shape runs
    of the port (the same iterations, transform and ``points[:n]`` within
    atol 5e-5, 2e-4 for the plane engines: JAX's tolerances) on the dense
    paths, trimmed or not, the grid path and the three plane engines, and
    the padded run equals JAX's padded run (the same iterations, points
    within the same tolerance).
  * kNN normals of a sentinel-padded cloud equal the unpadded normals on
    the real rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_tpu
from icp_tpu.ops import padding as jpad
from icp_tpu_torch import ICPConfig, icp
from icp_tpu_torch.engine.icp import ICPGuardError
from icp_tpu_torch.engine.plane import run_engine
from icp_tpu_torch.ops.normals import estimate_normals
from icp_tpu_torch.ops.padding import (
    SENTINEL,
    auto_quantum,
    bucket_size,
    pad_to_bucket,
    replica_fill,
    resolve_auto_bucket,
    valid_mask,
)
from tests.test_padding import _pair, _plane_pair, _rng


def _same(padded, exact, n, atol=5e-5):
    assert int(padded.iters) == int(exact.iters)
    for a, b in zip(padded.transform, exact.transform):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol)
    np.testing.assert_allclose(float(padded.err), float(exact.err), rtol=1e-3, atol=1e-8)
    np.testing.assert_allclose(np.asarray(padded.points)[:n], np.asarray(exact.points)[:n],
                               atol=atol)


def test_host_functions_match_jax():
    for n in (1, 100, 4096, 4097, 40256):
        assert bucket_size(n) == jpad.bucket_size(n)
        assert bucket_size(n, quantum=64) == jpad.bucket_size(n, quantum=64)
        assert auto_quantum(n) == jpad.auto_quantum(n)
    assert auto_quantum(2903) == 512 and auto_quantum(512) == 64
    clouds = [np.zeros((120, 3)), np.zeros((90, 3))]
    assert resolve_auto_bucket(clouds, "cpu") == jpad.resolve_auto_bucket(clouds) == 64
    assert resolve_auto_bucket(clouds[:1], "cpu") is None
    with pytest.raises(ValueError):
        bucket_size(0)
    with pytest.raises(ValueError):
        auto_quantum(0)


def test_pad_to_bucket_sentinels():
    c = _rng().standard_normal((100, 3)).astype(np.float32)
    padded, n = pad_to_bucket(c, quantum=64)
    want, wn = jpad.pad_to_bucket(c, quantum=64)
    assert padded.shape == (128, 3) and n == wn == 100
    np.testing.assert_array_equal(padded, want)
    assert np.all(padded[100:] == SENTINEL)
    same, n2 = pad_to_bucket(c, quantum=64, n_pad=100)
    assert same.shape == (100, 3) and n2 == 100
    with pytest.raises(ValueError):
        pad_to_bucket(c, n_pad=50)


@pytest.mark.parametrize("n_valid", [1, 5, 8])
def test_replica_fill_and_mask_match_jax(n_valid):
    c = _rng().standard_normal((8, 3)).astype(np.float32)
    want = np.asarray(jpad.replica_fill(jnp.asarray(c), n_valid))
    for nv in (n_valid, torch.tensor(n_valid)):  # an int or a 0-d tensor: no host read
        np.testing.assert_array_equal(replica_fill(torch.tensor(c), nv).numpy(), want)
    np.testing.assert_array_equal(valid_mask(8, n_valid, torch.float32).numpy(),
                                  np.asarray(jpad.valid_mask(8, n_valid, jnp.float32)))


@pytest.mark.parametrize("trim", [0.0, 0.2])
@pytest.mark.parametrize("nn,solver", [("bcast", "eigh"), ("pallas", "qcp_fused")])
def test_dense_bucketed_matches_exact(nn, solver, trim):
    model, scene = _pair(_rng())
    base = dict(max_iter=40, validate_inputs=False, with_scale=False, trim_fraction=trim)
    cfg = ICPConfig(solver=solver, nn_method=nn, **base)
    exact = icp(model, scene, cfg, device="cpu")
    m_pad, m_n = pad_to_bucket(model, quantum=128)
    s_pad, s_n = pad_to_bucket(scene, quantum=128)
    padded = icp(m_pad, s_pad, cfg, scene_n=s_n, model_n=m_n, device="cpu")
    _same(padded, exact, s_n)
    jres = icp_tpu.icp(m_pad, s_pad, icp_tpu.ICPConfig(solver="eigh", nn_method="bcast", **base),
                       scene_n=s_n, model_n=m_n)
    _same(padded, jres, s_n)


def test_grid_bucketed_matches_exact():
    model, scene = _pair(_rng(), n_model=700, n_scene=530)
    cfg = ICPConfig(max_iter=40, solver="qcp_fused", nn_method="grid", validate_inputs=False,
                    with_scale=False, grid_scene_tile=64, grid_model_tile=128)
    exact = icp(model, scene, cfg, device="cpu")
    m_pad, m_n = pad_to_bucket(model, quantum=256)
    s_pad, s_n = pad_to_bucket(scene, quantum=256)
    padded = icp(m_pad, s_pad, cfg, scene_n=s_n, model_n=m_n, device="cpu")
    _same(padded, exact, s_n)


def test_trace_and_guard_paths_bucketed():
    model, scene = _pair(_rng())
    cfg = ICPConfig(max_iter=40, solver="eigh", nn_method="bcast", validate_inputs=False,
                    with_scale=False)
    m_pad, m_n = pad_to_bucket(model, quantum=128)
    s_pad, s_n = pad_to_bucket(scene, quantum=128)
    exact = icp(model, scene, cfg, trace=True, device="cpu")
    padded = icp(m_pad, s_pad, cfg, scene_n=s_n, model_n=m_n, trace=True, device="cpu")
    n = int(exact.result.iters)
    assert int(padded.result.iters) == n
    np.testing.assert_allclose(padded.errs[:n].numpy(), exact.errs[:n].numpy(), rtol=1e-3,
                               atol=1e-8)
    guarded = icp(m_pad, s_pad, cfg, scene_n=s_n, model_n=m_n, guard="device", device="cpu")
    assert int(guarded.iters) == n
    s_bad = s_pad.copy()
    s_bad[3, 0] = np.nan  # a real row: the guard stops at once
    with pytest.raises(ICPGuardError, match="iteration 1"):
        icp(m_pad, s_bad, cfg, scene_n=s_n, model_n=m_n, guard="device", device="cpu")


def test_dispatch_reads_the_true_counts(monkeypatch):
    """R1: ``auto`` resolves on the real rows, not the padded shape (JAX
    compares the padded shape, ``icp_tpu/engine/icp.py:752``)."""
    from icp_tpu_torch.engine import grid

    seen = []
    monkeypatch.setattr(grid, "_icp_grid", lambda *a, **k: seen.append(1))
    monkeypatch.setattr(ICPConfig, "resolved_nn_method",
                        lambda self, backend, n=None: seen.append(n) or "bcast")
    model, scene = _pair(_rng())
    m_pad, m_n = pad_to_bucket(model, quantum=4096)
    s_pad, s_n = pad_to_bucket(scene, quantum=4096)
    icp(m_pad, s_pad, ICPConfig(max_iter=2, validate_inputs=False), scene_n=s_n, model_n=m_n,
        device="cpu")
    assert seen == [max(m_n, s_n)]


@pytest.mark.parametrize("nn", ["bcast", "grid"])
@pytest.mark.parametrize("engine", ["point_to_plane", "gicp", "symmetric"])
def test_plane_engines_bucketed_match_exact(engine, nn):
    """Normals estimated inside the engines on the sentinel-padded clouds
    (exact for the real rows), then replica-filled."""
    model, scene = _plane_pair()
    cfg = ICPConfig(max_iter=25, nn_method=nn, validate_inputs=False, with_scale=False,
                    threshold=1e-10, grid_scene_tile=64, grid_model_tile=128)
    exact = run_engine(engine, model, scene, cfg, device="cpu")
    m_pad, m_n = pad_to_bucket(model, quantum=256)
    s_pad, s_n = pad_to_bucket(scene, quantum=256)
    padded = run_engine(engine, m_pad, s_pad, cfg, scene_n=s_n, model_n=m_n, device="cpu")
    _same(padded, exact, s_n, atol=2e-4)


@pytest.mark.parametrize("engine", ["point_to_plane", "symmetric"])
def test_plane_engines_bucketed_trimmed_match_jax(engine):
    """Bucketed and trimmed together: the masked quantile leaves the pad rows
    out; the port's padded run equals its exact run and JAX's padded run."""
    from icp_tpu.engine.point_to_plane import icp_point_to_plane as j_p2pl
    from icp_tpu.engine.symmetric import icp_symmetric as j_sym

    model, scene = _plane_pair()
    base = dict(max_iter=25, nn_method="bcast", validate_inputs=False, with_scale=False,
                threshold=1e-10, trim_fraction=0.25)
    exact = run_engine(engine, model, scene, ICPConfig(**base), device="cpu")
    m_pad, m_n = pad_to_bucket(model, quantum=256)
    s_pad, s_n = pad_to_bucket(scene, quantum=256)
    padded = run_engine(engine, m_pad, s_pad, ICPConfig(**base), scene_n=s_n, model_n=m_n,
                        device="cpu")
    _same(padded, exact, s_n, atol=2e-4)
    jfn = j_p2pl if engine == "point_to_plane" else j_sym
    jres = jfn(m_pad, s_pad, icp_tpu.ICPConfig(**base), scene_n=s_n, model_n=m_n)
    _same(padded, jres, s_n, atol=2e-4)


@pytest.mark.parametrize("method", ["dense", "grid"])
def test_normals_exact_on_sentinel_padding(method):
    """kNN-PCA normals of a sentinel-padded cloud equal the unpadded
    normals on every real row (sentinels are never among the k nearest),
    through K6's (``dense``) and K7's (``grid``) plain versions."""
    c = _rng().standard_normal((300, 3)).astype(np.float32)
    want = estimate_normals(c, k=8, method=method, device="cpu").numpy()
    padded, n = pad_to_bucket(c, quantum=256)
    got_all = estimate_normals(padded, k=8, method=method, device="cpu").numpy()
    dots = np.abs(np.sum(want * got_all[:n], axis=1))  # the sign is arbitrary
    np.testing.assert_allclose(dots, 1.0, atol=1e-5)
    assert np.all(np.isfinite(got_all))
