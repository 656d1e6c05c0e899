"""The port's main path on cow, against the reference binary and JAX.

``solver="qcp_fused"`` with ``nn_method`` ``pallas`` (the fused path: one
K3 launch an iteration, its last block solving) and ``grid`` (K1 seed, K4,
K2), on the CPU through the kernels' plain versions.  Tolerances:
  * trace vs the reference binary: rtol 1e-2 on entries > 1e-6 — float32
    coordinates alone put JAX's explicit-residual path 3.1e-3 off it;
  * output cloud vs the binary's output.txt: atol 1e-5 (both printed at 6
    significant digits in the binary's file);
  * trace vs JAX's same configuration: rtol 1e-2, atol 5e-5, iterations
    within one — the JAX kernels' float32 closed-form residual carries
    ~2e-5 of noise on cow and stops its grid path at 6 iterations on
    cow_tr1 (ROADMAP C6), where the port's float64 sums stop at 7.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_tpu
import icp_tpu_torch
from icp_tpu_torch import ICPConfig
from icp_tpu_torch.engine.icp import icp, icp_fixed_iters
from icp_tpu_torch.utils.convert import similarity_from_numpy, similarity_to_numpy
from tests.conftest import data_path
from tests.test_golden_reference import reference_output, reference_trace

GOLDEN_ITERS = {"cow_tr1": 7, "cow_tr2": 10}


@pytest.fixture(scope="module")
def cow():
    load = icp_tpu_torch.load_matrix
    return {"ref": load(data_path("cow_ref.txt")), "cow_tr1": load(data_path("cow_tr1.txt")),
            "cow_tr2": load(data_path("cow_tr2.txt"))}


def _run(cow, fixture, nn, **kw):
    cfg = ICPConfig(max_iter=10, solver="qcp_fused", nn_method=nn)
    return icp(cow["ref"], cow[fixture], cfg, trace=True, device="cpu", **kw)


@pytest.mark.parametrize("fixture", ["cow_tr1", "cow_tr2"])
@pytest.mark.parametrize("nn", ["pallas", "grid"])
def test_cow_matches_reference_binary(cow, nn, fixture):
    tr = _run(cow, fixture, nn)
    iters = int(tr.result.iters)
    assert iters == GOLDEN_ITERS[fixture]
    got = tr.errs[:iters].numpy().astype(np.float64)
    want = np.asarray(reference_trace(fixture))
    big = want > 1e-6
    np.testing.assert_allclose(got[big], want[big], rtol=1e-2)
    assert np.all(got[~big] < 1e-6)
    assert torch.isnan(tr.errs[iters:]).all()
    np.testing.assert_allclose(tr.result.points.numpy(), reference_output(fixture), atol=1e-5)
    assert float(tr.result.err) == pytest.approx(float(got[-1]))


@pytest.mark.parametrize("nn", ["pallas", "grid"])
def test_cow_matches_jax_same_config(cow, nn):
    cfg = icp_tpu.ICPConfig(max_iter=10, solver="qcp_fused", nn_method=nn)
    jtr = icp_tpu.icp(cow["ref"], cow["cow_tr1"], cfg, trace=True)
    jn = int(jtr.result.iters)
    tr = _run(cow, "cow_tr1", nn)
    n = int(tr.result.iters)
    assert abs(n - jn) <= 1
    k = min(n, jn)
    np.testing.assert_allclose(tr.errs[:k].numpy(), np.asarray(jtr.errs)[:k],
                               rtol=1e-2, atol=5e-5)
    np.testing.assert_allclose(tr.result.points.numpy(), np.asarray(jtr.result.points),
                               atol=1e-3)


def test_warm_start_through_convert_matches_jax(cow):
    """Both engines start from the same ``init`` (built once in numpy)."""
    rng = np.random.default_rng(0)
    ang = 0.02
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    init_np = (np.float64(1.01), R, 0.005 * rng.standard_normal(3))
    jinit = icp_tpu.Similarity(*(jnp.asarray(v, jnp.float32) for v in init_np))
    jtr = icp_tpu.icp(cow["ref"], cow["cow_tr1"],
                      icp_tpu.ICPConfig(max_iter=10, solver="qcp_fused", nn_method="pallas"),
                      trace=True, init=jinit)
    tinit = similarity_from_numpy([np.asarray(v) for v in jinit])
    tr = _run(cow, "cow_tr1", "pallas", init=tinit)
    jn, n = int(jtr.result.iters), int(tr.result.iters)
    assert abs(n - jn) <= 1
    k = min(n, jn)
    np.testing.assert_allclose(tr.errs[:k].numpy(), np.asarray(jtr.errs)[:k],
                               rtol=1e-2, atol=5e-5)
    for a, b in zip(similarity_to_numpy(tr.result.transform), jtr.result.transform):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)


def test_float64_plain_path_matches_reference_binary(cow):
    """``bcast`` + ``eigh`` in float64 (the CPU default solver) reproduces
    the binary's trace to its printed precision, as the JAX f64 engine does."""
    cfg = ICPConfig(max_iter=10, dtype=torch.float64, solver="eigh", nn_method="bcast")
    tr = icp(cow["ref"], cow["cow_tr1"], cfg, trace=True, device="cpu")
    iters = int(tr.result.iters)
    np.testing.assert_allclose(tr.errs[:iters].numpy(), reference_trace("cow_tr1"), rtol=1e-5)
    np.testing.assert_allclose(tr.result.points.numpy(), reference_output("cow_tr1"), atol=5e-6)


@pytest.mark.parametrize("nn", ["pallas", "grid"])
def test_fixed_iters_runs_every_iteration(cow, nn):
    res = icp_fixed_iters(cow["ref"], cow["cow_tr1"], n_iters=9, solver="qcp_fused",
                          nn_method=nn, device="cpu")
    assert int(res.iters) == 9  # no convergence exit at iteration 7
    tr = _run(cow, "cow_tr1", nn)
    np.testing.assert_allclose(res.points.numpy(), tr.result.points.numpy(), atol=1e-5)


def test_n_iters_bound_and_plain_result(cow):
    res = icp(cow["ref"], cow["cow_tr1"],
              ICPConfig(max_iter=10, solver="qcp_fused", nn_method="pallas"), n_iters=3,
              device="cpu")
    assert int(res.iters) == 3 and math.isfinite(float(res.err))
    with pytest.raises(ValueError, match="exceeds"):
        icp(cow["ref"], cow["cow_tr1"], ICPConfig(max_iter=2), n_iters=3, device="cpu")
    # nb_iter 0 (the reference's atoi of garbage): no iteration, scene as given
    tr = icp(cow["ref"], cow["cow_tr1"],
             ICPConfig(max_iter=0, solver="qcp_fused", nn_method="pallas"), trace=True,
             device="cpu")
    assert int(tr.result.iters) == 0 and math.isinf(float(tr.result.err))
    assert tr.errs.shape == (0,)
    np.testing.assert_array_equal(tr.result.points.numpy(),
                                  cow["cow_tr1"].astype(np.float32))


def test_guard_raises_on_non_finite(cow):
    scene = cow["cow_tr1"].copy()
    scene[5] = np.nan
    with pytest.raises(FloatingPointError):
        icp(cow["ref"], scene, ICPConfig(max_iter=3, solver="qcp_fused", nn_method="pallas"),
            guard=True, device="cpu")


def test_input_checks_and_options_not_ported(cow):
    """The input checks, and the two options that raised
    ``NotImplementedError`` before they were ported: trim runs, and
    ``guard="device"`` leaves a clean run bit-equal to the unguarded one."""
    with pytest.raises(ValueError, match="same number"):
        icp(cow["ref"], cow["cow_tr1"][:100], device="cpu")
    with pytest.raises(ValueError, match="at least 4"):
        icp(cow["ref"][:3], cow["cow_tr1"][:3], device="cpu")
    trimmed = icp(cow["ref"], cow["cow_tr1"], ICPConfig(max_iter=10, trim_fraction=0.1),
                  device="cpu")
    assert 1 <= int(trimmed.iters) <= 10 and math.isfinite(float(trimmed.err))
    plain = icp(cow["ref"], cow["cow_tr1"], ICPConfig(max_iter=10), device="cpu")
    guarded = icp(cow["ref"], cow["cow_tr1"], ICPConfig(max_iter=10), guard="device",
                  device="cpu")
    assert int(guarded.iters) == int(plain.iters) == GOLDEN_ITERS["cow_tr1"]
    assert torch.equal(guarded.points, plain.points)
    with pytest.raises(ValueError, match="guard"):
        icp(cow["ref"], cow["cow_tr1"], guard="host", device="cpu")


# The card's grid threshold, as scripts/dispatch_sweep.py measured it on the
# H100 (perf_h100/dispatch_sweep.jsonl); JAX's TPU value is 4,096.
CARD_GRID_THRESHOLD = 65536


@pytest.mark.parametrize("n", [2903, 4095, 4096, 48485, CARD_GRID_THRESHOLD - 1,
                               CARD_GRID_THRESHOLD, CARD_GRID_THRESHOLD + 1])
def test_auto_resolution_mirrors_jax(n):
    """On the CPU "auto" resolves as JAX's at every size; on the card at
    the card's measured threshold (JAX's TPU resolution takes the grid from
    4,096)."""
    cfg = ICPConfig()
    jcfg = icp_tpu.ICPConfig()
    assert icp_tpu_torch.GRID_AUTO_THRESHOLD == CARD_GRID_THRESHOLD
    assert cfg.resolved_nn_method("cpu", n) == jcfg.resolved_nn_method("cpu", n)
    assert cfg.resolved_nn_method("cuda", n) == ("grid" if n >= CARD_GRID_THRESHOLD
                                                 else "pallas")
    assert cfg.resolved_solver("cuda") == jcfg.resolved_solver("tpu") == "qcp_fused"
    assert cfg.resolved_solver("cpu") == jcfg.resolved_solver("cpu") == "eigh"


def test_qcp_fused_with_bcast_takes_k5_and_the_explicit_residual(cow, monkeypatch):
    """As JAX (``icp_tpu/engine/icp.py:171``), ``qcp_fused`` with an NN other
    than ``pallas`` is the plain step: K5 for the rotation, then the explicit
    residual, and no K2.  Iterations equal JAX's.  The trace is within
    rtol 1e-2 of JAX's: JAX solves in float32 and lands 3.1e-3 off the
    reference binary at iteration 4, while the port's float64 solve stays
    within 1e-5 of the binary on every entry > 1e-6."""
    import icp_tpu_torch.engine.icp as engine
    from icp_tpu_torch.kernels import qcp as tq

    calls = []
    real = tq.qcp_rotation_from
    monkeypatch.setattr(tq, "qcp_rotation_from", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(engine, "qcp_step", None)  # K2 must not be reached
    cfg = dict(max_iter=30, solver="qcp_fused", nn_method="bcast")
    jtr = icp_tpu.icp(cow["ref"], cow["cow_tr1"], icp_tpu.ICPConfig(**cfg), trace=True)
    tr = icp(cow["ref"], cow["cow_tr1"], ICPConfig(**cfg), trace=True, device="cpu")
    n = int(tr.result.iters)
    assert n == int(jtr.result.iters) == GOLDEN_ITERS["cow_tr1"] and len(calls) == n
    got = tr.errs[:n].numpy().astype(np.float64)
    big = got > 1e-6
    np.testing.assert_allclose(got[big], np.asarray(jtr.errs)[:n][big], rtol=1e-2)
    want = np.asarray(reference_trace("cow_tr1"))
    np.testing.assert_allclose(got[big], want[big], rtol=1e-5)
    # the explicit residual: after one step, 2 x the mean squared distance
    # from the moved scene to its first matches
    from icp_tpu_torch.ops.distance import closest_point_indices

    one = icp(cow["ref"], cow["cow_tr1"], ICPConfig(**dict(cfg, max_iter=1)), device="cpu")
    model = torch.tensor(cow["ref"], dtype=torch.float32)
    scene = torch.tensor(cow["cow_tr1"], dtype=torch.float32)
    y = model[closest_point_indices(scene, model, method="bcast").long()]
    resid = 2.0 * float(((y - one.points) ** 2).sum(1).mean())
    assert float(one.err) == pytest.approx(resid, rel=1e-5)


def test_numpy_input_targets_the_card(cow, monkeypatch):
    from icp_tpu_torch.engine.icp import target_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert target_device(cow["ref"]) == torch.device("cuda")
    assert target_device(torch.zeros(4, 3)) == torch.device("cpu")  # a tensor stays
    assert target_device(cow["ref"], "cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        icp(cow["ref"], cow["cow_tr1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        icp_fixed_iters(cow["ref"], cow["cow_tr1"], n_iters=2)
    res = icp(torch.tensor(cow["ref"]), torch.tensor(cow["cow_tr1"]),
              ICPConfig(max_iter=2), n_iters=1)
    assert res.points.device.type == "cpu" and int(res.iters) == 1
