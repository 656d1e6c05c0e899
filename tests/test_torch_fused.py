"""K3 (whole dense iteration) plain version vs the JAX fused kernel.

The JAX kernel runs in interpret mode.  The port keeps float32 coordinates
and distances and accumulates the Horn sums and the solve in float64, the
JAX kernel does all of it in float32; so the tolerances are K2's: R/t atol
1e-5, s rtol 1e-5, the closed-form residual rtol 1e-3.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_tpu.kernels import icp_fused as jf
from icp_tpu.kernels import qcp_pallas as jq
from icp_tpu.ops.alignment import Similarity as JSim
from icp_tpu_torch.kernels import icp_fused as tf
from icp_tpu_torch.kernels import qcp as tq
from icp_tpu_torch.utils.convert import state_from_jax, state_to_jax
from tests.conftest import random_rotation


def _warm_state(seed):
    rng = np.random.default_rng(seed)
    sim = JSim(jnp.float32(1.05), jnp.asarray(random_rotation(rng), jnp.float32),
               jnp.asarray(0.1 * rng.standard_normal(3), jnp.float32))
    return np.asarray(jq.pack_total_state(sim))


@pytest.mark.parametrize("warm", [False, True], ids=["identity", "warm"])
@pytest.mark.parametrize("n,m", [(16, 100), (100, 300), (257, 950)])
def test_fused_step_matches_jax(n, m, warm):
    rng = np.random.default_rng(n * m)
    p = rng.standard_normal((n, 3)).astype(np.float32)
    model = (2.0 * rng.standard_normal((m, 3))).astype(np.float32)
    prev = _warm_state(n) if warm else np.asarray(jq.identity_state())
    want = np.asarray(jf.fused_icp_step(
        jf.prepare_fused_inputs(jnp.asarray(p), jnp.asarray(model)),
        jnp.asarray(prev), interpret=True))
    prep = tf.prepare_fused_inputs(torch.tensor(p), torch.tensor(model))
    state = state_from_jax(prev)
    tf.fused_icp_step(prep, state, tq.new_loop_control(1), tq.new_err_buffer(1),
                      threshold=1e-5, err_factor=2.0)
    got = state_to_jax(state).astype(np.float64)
    for sl in (slice(1, 10), slice(10, 13), slice(14, 23), slice(23, 26)):
        np.testing.assert_allclose(got[0, sl], want[0, sl], atol=1e-5)
    for k in (0, 13):
        np.testing.assert_allclose(got[0, k], want[0, k], rtol=1e-5)
    np.testing.assert_allclose(got[0, 26], want[0, 26], rtol=1e-3)


def test_prepare_fused_inputs_layout():
    rng = np.random.default_rng(1)
    model = rng.standard_normal((37, 3)).astype(np.float32)
    prep = tf.prepare_fused_inputs(torch.tensor(rng.standard_normal((9, 3))),
                                   torch.tensor(model))
    assert prep.p0.shape == (9, 3) and prep.p0.dtype == torch.float32 and prep.p0.is_contiguous()
    np.testing.assert_array_equal(prep.mt[:, :3].numpy(), -2.0 * model)
    jmt = np.asarray(jf.prepare_fused_inputs(jnp.zeros((9, 3)), jnp.asarray(model))[1])
    np.testing.assert_allclose(prep.mt[:, 3].numpy(), jmt[3, :37], rtol=1e-6)


# The card's fused cap: the largest model scripts/dispatch_sweep.py measured
# K3 at, faster there than the pipeline (perf_h100/dispatch_sweep.jsonl).
CARD_FUSED_CAP = 262144


def _model(n: int, on_card: bool):
    """What the gate reads of a model: its rows and whether it is on the
    card (a card's tensor cannot be made here)."""
    return SimpleNamespace(shape=(n, 3), is_cuda=on_card)


@pytest.mark.parametrize("n", [100, 5119, 5120, 5121, CARD_FUSED_CAP - 1, CARD_FUSED_CAP,
                               CARD_FUSED_CAP + 1])
def test_fused_path_gating(n):
    """On CPU tensors the gate is JAX's at every size; on the card's its cap
    is the measured one."""
    assert tf.MAX_FUSED_MODEL == jf._MAX_FUSED_MODEL
    assert tf.MAX_FUSED_MODEL_CUDA == CARD_FUSED_CAP
    cpu = torch.empty((n, 3))
    for solver, nn, trim in (("qcp_fused", "pallas", 0.0), ("qcp_fused", "bcast", 0.0),
                             ("eigh", "pallas", 0.0), ("qcp_fused", "pallas", 0.1)):
        want = jf.fused_path_available(solver, nn, trim, n)
        assert tf.fused_path_available(solver, nn, trim, cpu) == want
        assert tf.fused_path_available(solver, nn, trim, _model(n, True)) == (
            solver == "qcp_fused" and nn == "pallas" and trim == 0.0 and n <= CARD_FUSED_CAP)
    assert not tf.fused_path_available("qcp_fused", "pallas", 0.0, _model(n, True), masked=True)


def test_fused_step_after_done_is_a_no_op():
    rng = np.random.default_rng(2)
    p = torch.tensor(rng.standard_normal((50, 3)), dtype=torch.float32)
    prep = tf.prepare_fused_inputs(p, p * 1.1)
    state, ctl, errs = tq.identity_state(), tq.new_loop_control(1), tq.new_err_buffer(1)
    tf.fused_icp_step(prep, state, ctl, errs, threshold=1e-5, err_factor=2.0)
    assert ctl.tolist() == [1, 1, 1, 0]  # the bound of 1 is reached
    before = state.clone()
    tf.fused_icp_step(prep, state, ctl, errs, threshold=1e-5, err_factor=2.0)
    assert ctl.tolist() == [1, 1, 1, 0]
    np.testing.assert_array_equal(state[0, 13:].numpy(), before[0, 13:].numpy())
    assert float(state[0, 0]) == 1.0 and float(state[0, 10:13].abs().sum()) == 0.0


def _nan_model_case():
    """The NaN-wins case: a 64-point scene against a 100-point model (the
    scene x 1.05 + 0.01, then 36 seeded rows), one NaN coordinate in model
    row 70."""
    rng = np.random.default_rng(0)
    scene = rng.standard_normal((64, 3)).astype(np.float32)
    model = np.concatenate([scene * 1.05 + 0.01, rng.standard_normal((36, 3))]).astype(np.float32)
    model[70, 1] = np.nan
    return scene, model


@pytest.mark.parametrize("warm", [False, True], ids=["identity", "warm"])
def test_fused_step_with_a_nan_model_row_matches_jax(warm):
    """A NaN distance never wins in the JAX kernel (strict ``dc < best``)
    nor in K3: one step is finite and within the tolerances above (the
    residual, near zero here, within 1e-3 of JAX's float32 one)."""
    scene, model = _nan_model_case()
    prev = _warm_state(5) if warm else np.asarray(jq.identity_state())
    want = np.asarray(jf.fused_icp_step(
        jf.prepare_fused_inputs(jnp.asarray(scene), jnp.asarray(model)),
        jnp.asarray(prev), interpret=True))
    state, errs = state_from_jax(prev), tq.new_err_buffer(1)
    tf.fused_icp_step(tf.prepare_fused_inputs(torch.tensor(scene), torch.tensor(model)),
                      state, tq.new_loop_control(1), errs, threshold=1e-5, err_factor=2.0)
    got = state_to_jax(state).astype(np.float64)
    assert np.isfinite(got).all() and np.isfinite(errs.numpy()).all()
    for sl in (slice(1, 10), slice(10, 13), slice(14, 23), slice(23, 26)):
        np.testing.assert_allclose(got[0, sl], want[0, sl], atol=1e-5)
    for k in (0, 13):
        np.testing.assert_allclose(got[0, k], want[0, k], rtol=1e-5)
    np.testing.assert_allclose(got[0, 26], want[0, 26], atol=1e-3)


def test_icp_with_a_nan_model_row_matches_jax():
    """``icp`` on the fused path (K3's and K2's plain versions on the CPU) against JAX's
    ``icp`` on the same pair: the same iterations, a finite transform."""
    import icp_tpu
    from icp_tpu_torch import ICPConfig, icp

    scene, model = _nan_model_case()
    kw = dict(max_iter=10, solver="qcp_fused", nn_method="pallas", validate_inputs=False)
    jtr = icp_tpu.icp(model, scene, icp_tpu.ICPConfig(**kw), trace=True)
    tr = icp(model, scene, ICPConfig(**kw), trace=True, device="cpu")
    assert int(tr.result.iters) == int(jtr.result.iters)
    s, R, t = (v.numpy() for v in tr.result.transform)
    js, jR, jt = (np.asarray(v) for v in jtr.result.transform)
    assert np.isfinite(s) and np.isfinite(R).all() and np.isfinite(t).all()
    np.testing.assert_allclose(s, js, rtol=1e-5)
    np.testing.assert_allclose(R, jR, atol=1e-5)
    np.testing.assert_allclose(t, jt, atol=1e-5)
    np.testing.assert_allclose(tr.result.points.numpy(), np.asarray(jtr.result.points), atol=1e-5)


def test_plain_nan_scene_row_matches_y_zero():
    """A scene row with no finite distance (a NaN coordinate) matches y = 0
    in ``fused_partials_plain``, as the kernel's and JAX's zeroed carry
    give: the y sums equal those of the scene without that row; the p sums
    are NaN."""
    rng = np.random.default_rng(8)
    scene = rng.standard_normal((50, 3)).astype(np.float32)
    model = (2.0 * rng.standard_normal((80, 3))).astype(np.float32)
    scene[11, 0] = np.nan
    keep = np.arange(50) != 11
    state = tq.identity_state()
    got = tf.fused_partials_plain(tf.prepare_fused_inputs(torch.tensor(scene),
                                                          torch.tensor(model)), state)
    want = tf.fused_partials_plain(tf.prepare_fused_inputs(torch.tensor(scene[keep]),
                                                           torch.tensor(model)), state)
    y_cols = [12, 13, 14, 16]
    np.testing.assert_allclose(got[0, y_cols].numpy(), want[0, y_cols].numpy(), rtol=1e-12)
    assert np.isnan(got[0, 9:12].numpy()).all() and float(got[0, 17]) == 50.0
