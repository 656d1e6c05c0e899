"""icp_tpu_torch alignment algebra and K2's plain version vs the JAX package.

Inputs are made with numpy from a seed and handed to both packages.  The
plain solvers are compared in float64 (atol 1e-10).  K2 (the scalar
alignment step) runs in float64 in the port and in float32 in the JAX
kernel (interpret mode), so those comparisons take float32 tolerances:
R/t atol 1e-5, s rtol 1e-5, the closed-form residual rtol 1e-3.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_tpu.kernels import qcp_pallas as jq
from icp_tpu.ops import alignment as ja
from icp_tpu.ops import transform as jt
from icp_tpu_torch.kernels import _build
from icp_tpu_torch.kernels import qcp as tq
from icp_tpu_torch.ops import alignment as ta
from icp_tpu_torch.ops import transform as tt
from icp_tpu_torch.utils.convert import (
    similarity_from_numpy,
    similarity_to_numpy,
    state_from_jax,
    state_to_jax,
)
from tests.conftest import random_rotation


def _pair(seed, n=500, noise=0.01, centred=False):
    """Seeded clouds with y ~ s R p + t."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((n, 3))
    if centred:
        p -= p.mean(0)
    R = random_rotation(rng)
    s = rng.uniform(0.7, 1.4)
    t = rng.standard_normal(3)
    y = s * p @ R.T + t + noise * rng.standard_normal((n, 3))
    if centred:
        y -= y.mean(0)
    return p, y


def _t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _stats_pair(p, y, weights=None):
    js = ja.compute_alignment_stats(jnp.asarray(p), jnp.asarray(y),
                                    weights=None if weights is None else jnp.asarray(weights))
    ts = ta.compute_alignment_stats(_t64(p), _t64(y),
                                    weights=None if weights is None else _t64(weights))
    return js, ts


@pytest.mark.parametrize("weighted", [False, True])
def test_stats_match_jax(weighted):
    p, y = _pair(1)
    w = np.random.default_rng(2).uniform(0, 1, len(p)) if weighted else None
    js, ts = _stats_pair(p, y, w)
    for a, b in zip(js, ts):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12, atol=1e-10)


@pytest.mark.parametrize("solver", ["eigh", "qcp", "kabsch"])
def test_solvers_match_jax(solver):
    p, y = _pair(3)
    js, ts = _stats_pair(p, y)
    jsim = ja.alignment_from_stats(js, solver=solver)
    tsim = ta.alignment_from_stats(ts, solver=solver)
    for a, b in zip(jsim, tsim):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-10)


def test_qcp_fused_solver_matches_eigh():
    """``solver="qcp_fused"`` goes through K5 (its plain version here)."""
    p, y = _pair(4)
    _, ts = _stats_pair(p, y)
    want = ta.alignment_from_stats(ts, solver="eigh")
    got = ta.alignment_from_stats(ts, solver="qcp_fused")
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-10)


def test_horn_matrix_and_quaternion_match_jax():
    rng = np.random.default_rng(5)
    S = rng.standard_normal((3, 3))
    np.testing.assert_allclose(ta.horn_n_matrix(_t64(S)).numpy(),
                               np.asarray(ja.horn_n_matrix(jnp.asarray(S))), atol=1e-12)
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    np.testing.assert_allclose(ta.quat_to_rot(_t64(q)).numpy(),
                               np.asarray(ja.quat_to_rot(jnp.asarray(q))), atol=1e-12)


def test_transform_ops_match_jax():
    rng = np.random.default_rng(6)
    sims = []
    for _ in range(2):
        sims.append((rng.uniform(0.5, 2.0), random_rotation(rng), rng.standard_normal(3)))
    j = [ja.Similarity(*(jnp.asarray(v) for v in s)) for s in sims]
    t = [similarity_from_numpy(s, torch.float64) for s in sims]
    p = rng.standard_normal((40, 3))
    y = rng.standard_normal((40, 3))
    pairs = [
        (jt.compose(j[0], j[1]), tt.compose(t[0], t[1])),
        (jt.inverse(j[0]), tt.inverse(t[0])),
    ]
    for js, ts in pairs:
        for a, b in zip(js, similarity_to_numpy(ts)):
            np.testing.assert_allclose(b, np.asarray(a), atol=1e-12)
    np.testing.assert_allclose(tt.apply_similarity(_t64(p), t[0]).numpy(),
                               np.asarray(jt.apply_similarity(jnp.asarray(p), j[0])),
                               atol=1e-12)
    np.testing.assert_allclose(float(tt.residual_error(_t64(p), _t64(y), t[1])),
                               float(jt.residual_error(jnp.asarray(p), jnp.asarray(y), j[1])),
                               rtol=1e-12)


def _jax_step(p, y, prev_np, with_scale):
    js = ja.compute_alignment_stats(jnp.asarray(p, jnp.float32), jnp.asarray(y, jnp.float32))
    out = jq.alignment_step_state_pallas(jq.pack_stats(js), jnp.asarray(prev_np),
                                         with_scale=with_scale, interpret=True)
    return np.asarray(out)


def _torch_step(p, y, prev_np, with_scale):
    ts = ta.compute_alignment_stats(_t64(p), _t64(y))
    state = state_from_jax(prev_np)
    ctl, errs = tq.new_loop_control(1), tq.new_err_buffer(1)
    tq.qcp_step(tq.pack_stats(ts), state, ctl, errs, with_scale=with_scale)
    return state


@pytest.mark.parametrize("n,with_scale,warm", [
    (50, True, False), (400, True, True), (1000, True, False), (1000, False, True),
])
def test_qcp_step_matches_jax_kernel(n, with_scale, warm):
    p, y = _pair(10 + n, n=n, noise=0.05, centred=True)
    prev = np.asarray(jq.identity_state())
    if warm:
        rng = np.random.default_rng(7)
        prev = np.asarray(jq.pack_total_state(ja.Similarity(
            jnp.float32(1.2), jnp.asarray(random_rotation(rng), jnp.float32),
            jnp.asarray(rng.standard_normal(3), jnp.float32))))
    want = _jax_step(p, y, prev, with_scale)
    got = state_to_jax(_torch_step(p, y, prev, with_scale)).astype(np.float64)
    for sl in (slice(1, 10), slice(10, 13), slice(14, 23), slice(23, 26)):  # R, t
        np.testing.assert_allclose(got[0, sl], want[0, sl], atol=1e-5)
    for k in (0, 13):  # s
        np.testing.assert_allclose(got[0, k], want[0, k], rtol=1e-5)
    np.testing.assert_allclose(got[0, 26], want[0, 26], rtol=1e-3)


@pytest.mark.parametrize("seed", [20, 21, 22])
def test_qcp_rotation_matches_jax_kernel(seed):
    """K5's plain version (float64) vs ``horn_rotation_pallas`` (the float32
    ``_qcp_kernel`` in interpret mode), on the same (1, 16) slots."""
    p, y = _pair(seed, n=300, noise=0.02, centred=True)
    js, ts = _stats_pair(p, y)
    n = ts.n
    S = ts.sum_py - n * torch.outer(ts.sum_p / n, ts.sum_y / n)
    gp = ts.sum_pp - n * torch.dot(ts.sum_p / n, ts.sum_p / n)
    gy = ts.sum_yy - n * torch.dot(ts.sum_y / n, ts.sum_y / n)
    packed = tq.pack_rotation_input(S, gp, gy)
    assert packed.shape == (1, 16) and not packed[0, 11:].any()
    out = tq.qcp_rotation(packed)
    jR, jq_, jlam = jq.horn_rotation_pallas(jnp.asarray(S.numpy(), jnp.float32),
                                            jnp.asarray(float(gp), jnp.float32),
                                            jnp.asarray(float(gy), jnp.float32), interpret=True)
    np.testing.assert_allclose(out[0, :9].reshape(3, 3).numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(out[0, 9:13].numpy(), np.asarray(jq_), atol=1e-5)
    np.testing.assert_allclose(float(out[0, 13]), float(jlam), rtol=1e-5)
    assert float(out[0, 14]) == float(out[0, 15]) == 0.0
    R = out[0, :9].reshape(3, 3)  # a rotation, and the one eigh gives
    np.testing.assert_allclose((R @ R.T).numpy(), np.eye(3), atol=1e-12)
    want = ta.alignment_from_stats(ts, solver="eigh").R
    np.testing.assert_allclose(R.numpy(), want.numpy(), atol=1e-10)


def _centred(seed):
    """S, gp, gy of a seeded centred pair (float64), as the K5 tests use."""
    p, y = _pair(seed, n=300, noise=0.02, centred=True)
    _, ts = _stats_pair(p, y)
    n = ts.n
    S = ts.sum_py - n * torch.outer(ts.sum_p / n, ts.sum_y / n)
    gp = ts.sum_pp - n * torch.dot(ts.sum_p / n, ts.sum_p / n)
    gy = ts.sum_yy - n * torch.dot(ts.sum_y / n, ts.sum_y / n)
    return S, gp, gy


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("seed", [20, 21, 22])
def test_qcp_rotation_from_matches_packed_plain_and_jax_kernel(seed, dtype):
    """``qcp_rotation_from(S, gp, gy)`` (its plain version here) is bit-equal
    to the packed path (``qcp_rotation_plain(pack_rotation_input(...))``,
    R cast back to S's dtype), and holds R and q within 1e-5 and lambda
    within rtol 1e-5 of ``horn_rotation_pallas`` (float32, interpret mode)."""
    S, gp, gy = (v.to(dtype) for v in _centred(seed))
    R, q, lam = tq.qcp_rotation_from(S, gp, gy)
    assert R.shape == (3, 3) and R.dtype == dtype
    assert q.shape == (4,) and lam.shape == () and q.dtype == lam.dtype == torch.float64
    packed = tq.qcp_rotation_plain(tq.pack_rotation_input(S, gp, gy))
    assert torch.equal(R, packed[0, :9].reshape(3, 3).to(dtype))
    assert torch.equal(q, packed[0, 9:13]) and torch.equal(lam, packed[0, 13])
    jR, jq_, jlam = jq.horn_rotation_pallas(jnp.asarray(S.double().numpy(), jnp.float32),
                                            jnp.asarray(float(gp), jnp.float32),
                                            jnp.asarray(float(gy), jnp.float32), interpret=True)
    np.testing.assert_allclose(R.double().numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq_), atol=1e-5)
    np.testing.assert_allclose(float(lam), float(jlam), rtol=1e-5)


def test_qcp_rotation_from_rejects_what_the_kernel_does_not_take():
    S, gp, gy = _centred(24)
    for args in ((S.T, gp, gy), (S.float(), gp, gy), (S[:2], gp, gy), (S.half(), gp.half(), gy.half()),
                 (S, torch.stack([gp, gp]), gy)):
        with pytest.raises(ValueError, match="qcp_rotation_from"):
            tq.qcp_rotation_from(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_qcp_fused_alignment_packs_nothing_on_the_host(dtype):
    """``alignment_from_stats(..., solver="qcp_fused")`` hands S, gp and gy
    to K5 as they are: no ``aten.cat`` and no ``aten.zeros`` (the packing),
    and its (s, R, t) is the packed path's bit for bit and JAX's
    ``alignment_from_stats(solver="qcp_fused")`` within float32 tolerances
    (R, t atol 1e-5, s rtol 1e-5)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    p, y = _pair(25)
    js, ts = _stats_pair(p, y)
    ts = ta.AlignmentStats(*(v.to(dtype) for v in ts))
    with Ops() as ops:
        got = ta.alignment_from_stats(ts, solver="qcp_fused")
    assert not [k for k in ops.names if k in ("aten.cat", "aten.zeros", "aten.new_zeros")], ops.names
    n = ts.n
    mu_p, mu_y = ts.sum_p / n, ts.sum_y / n
    S = ts.sum_py - n * torch.outer(mu_p, mu_y)
    gp = ts.sum_pp - n * torch.dot(mu_p, mu_p)
    gy = ts.sum_yy - n * torch.dot(mu_y, mu_y)
    R = tq.qcp_rotation(tq.pack_rotation_input(S, gp, gy))[0, :9].reshape(3, 3).to(dtype)
    assert torch.equal(got.R, R)
    jsim = ja.alignment_from_stats(ja.AlignmentStats(*(jnp.asarray(v, jnp.float32) for v in js)),
                                   solver="qcp_fused")
    np.testing.assert_allclose(got.R.double().numpy(), np.asarray(jsim.R), atol=1e-5)
    np.testing.assert_allclose(got.t.double().numpy(), np.asarray(jsim.t), atol=1e-5)
    np.testing.assert_allclose(float(got.s), float(jsim.s), rtol=1e-5)


def test_qcp_rotation_rejects_bad_blocks_and_counts_nothing_on_cpu():
    _build.reset_counts()
    with pytest.raises(ValueError, match="qcp_rotation"):
        tq.qcp_rotation(torch.zeros((1, 16), dtype=torch.float32))
    with pytest.raises(ValueError, match="qcp_rotation"):
        tq.qcp_rotation(torch.zeros((1, 15), dtype=torch.float64))
    p, y = _pair(23)
    _, ts = _stats_pair(p, y)
    ta.alignment_from_stats(ts, solver="qcp_fused")
    assert _build.LAUNCHES["qcp_rotation"] == 0  # CPU tensors take the plain version


def test_state_helpers_match_jax():
    rng = np.random.default_rng(8)
    sim = (1.1, random_rotation(rng), rng.standard_normal(3))
    jstate = np.asarray(jq.pack_total_state(ja.Similarity(*(jnp.asarray(v, jnp.float32) for v in sim))))
    tstate = tq.pack_total_state(similarity_from_numpy(sim, torch.float64))
    np.testing.assert_allclose(state_to_jax(tstate), jstate, atol=1e-7)
    np.testing.assert_array_equal(state_to_jax(tq.identity_state()),
                                  np.asarray(jq.identity_state()))
    step, total, resid = tq.unpack_state(state_from_jax(jstate))
    np.testing.assert_allclose(total.R.numpy(), sim[1], atol=1e-6)
    assert float(step.s) == 0.0 and float(resid) == 0.0


def test_qcp_step_loop_control():
    """K2's bookkeeping: errs[it], it += 1, done at threshold; once done,
    the step is the identity and the total stays as it is."""
    p, y = _pair(9, noise=0.0)
    ts = ta.compute_alignment_stats(_t64(p), _t64(y))
    parts = tq.pack_stats(ts)
    state, ctl, errs = tq.identity_state(), tq.new_loop_control(5), tq.new_err_buffer(5)
    tq.qcp_step(parts, state, ctl, errs, threshold=1e-5, err_factor=2.0)
    assert ctl.tolist() == [1, 1, 5, 0]  # exact fit: err below threshold at once
    assert errs[0] < 1e-5 and math.isnan(float(errs[1]))
    total = state[0, 13:26].clone()
    tq.qcp_step(parts, state, ctl, errs, threshold=1e-5, err_factor=2.0)
    assert ctl.tolist() == [1, 1, 5, 0]
    np.testing.assert_array_equal(state[0, 13:26].numpy(), total.numpy())
    np.testing.assert_array_equal(state[0, :13].numpy(),
                                  [1, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0])


def test_qcp_step_bound_ends_loop_and_cpu_counts_nothing():
    p, y = _pair(11, noise=0.3)
    parts = tq.pack_stats(ta.compute_alignment_stats(_t64(p), _t64(y)))
    state, ctl, errs = tq.identity_state(), tq.new_loop_control(2), tq.new_err_buffer(2)
    _build.reset_counts()
    for _ in range(2):
        tq.qcp_step(parts, state, ctl, errs, threshold=1e-5)
    assert ctl.tolist() == [2, 1, 2, 0]
    assert not torch.isnan(errs).any()
    assert _build.LAUNCHES["qcp_step"] == 0  # CPU tensors take the plain version
