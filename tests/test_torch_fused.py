"""K3 (whole dense iteration) plain version vs the JAX fused kernel.

The JAX kernel runs in interpret mode.  The port keeps float32 coordinates
and distances and accumulates the Horn sums and the solve in float64, the
JAX kernel does all of it in float32; so the tolerances are K2's: R/t atol
1e-5, s rtol 1e-5, the closed-form residual rtol 1e-3.
"""

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


def test_fused_path_gating():
    assert tf.fused_path_available("qcp_fused", "pallas", 0.0, tf.MAX_FUSED_MODEL)
    assert not tf.fused_path_available("qcp_fused", "pallas", 0.0, tf.MAX_FUSED_MODEL + 1)
    assert not tf.fused_path_available("qcp_fused", "bcast", 0.0, 100)
    assert not tf.fused_path_available("eigh", "pallas", 0.0, 100)
    assert not tf.fused_path_available("qcp_fused", "pallas", 0.1, 100)
    assert tf.MAX_FUSED_MODEL == jf._MAX_FUSED_MODEL


def test_fused_step_after_done_is_a_no_op():
    rng = np.random.default_rng(2)
    p = torch.tensor(rng.standard_normal((50, 3)), dtype=torch.float32)
    prep = tf.prepare_fused_inputs(p, p * 1.1)
    state, ctl, errs = tq.identity_state(), tq.new_loop_control(1), tq.new_err_buffer(1)
    tf.fused_icp_step(prep, state, ctl, errs, threshold=1e-5, err_factor=2.0)
    assert ctl.tolist() == [1, 1, 1]  # the bound of 1 is reached
    before = state.clone()
    tf.fused_icp_step(prep, state, ctl, errs, threshold=1e-5, err_factor=2.0)
    assert ctl.tolist() == [1, 1, 1]
    np.testing.assert_array_equal(state[0, 13:].numpy(), before[0, 13:].numpy())
    assert float(state[0, 0]) == 1.0 and float(state[0, 10:13].abs().sum()) == 0.0
