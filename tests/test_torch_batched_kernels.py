"""The pair axis of K1, K2, K3 and K5 (the counterpart of JAX's ``vmap`` over
a ``pallas_call``) and the batched engine paths that take it, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
JAX kernels run under ``jax.vmap`` in interpret mode, as the JAX package's
own tests run them on the CPU.  Here the wrappers take their plain
versions (CPU tensors), which run the single-pair plain version pair by
pair, so each pair is bit-equal to B separate calls.  Tolerances against
JAX: K1's indices equal (random data: XLA's contracted distances differ by
at most 2 ulp, no index flips); K2's and K3's states those of
``test_torch_alignment.py`` and ``test_torch_fused.py`` (the JAX kernels
solve in float32, the port in float64: R/t atol 1e-5, s rtol 1e-5, the
closed-form residual rtol 1e-3); K5's R and q atol 1e-5 and lambda rtol
1e-5; ``icp_batched`` points within 1e-5 of JAX's, or 5e-5 where JAX's
kernels solve in float32 (``qcp_fused``), as ``test_torch_batched.py``
holds its fused path; errors within rtol 1e-4 / atol 1e-7 of each pair's
own run on the paths that sum float32 over a pair axis, bit-equal on K3's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_tpu.engine import batched as jb
from icp_tpu.kernels import icp_fused as jf
from icp_tpu.kernels import nn_pallas as jn
from icp_tpu.kernels import qcp_pallas as jq
from icp_tpu.ops import alignment as ja
from icp_tpu_torch.engine import batched as tb
from icp_tpu_torch.engine.icp import icp_fixed_iters
from icp_tpu_torch.kernels import _build
from icp_tpu_torch.kernels import icp_fused as tf
from icp_tpu_torch.kernels import nn_dense as tn
from icp_tpu_torch.kernels import qcp as tq
from icp_tpu_torch.ops import alignment as ta
from icp_tpu_torch.utils.convert import state_from_jax, state_to_jax
from tests.conftest import random_rotation

B = 3
CPU = "cpu"


def _clouds(seed, b=B, n=200, m=170, scale=1.5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, 3)).astype(np.float32),
            (scale * rng.standard_normal((b, m, 3))).astype(np.float32))


def _warm_states(seed, b=B):
    """(B, 1, 32) float32 JAX state blocks of seeded similarities."""
    rng = np.random.default_rng(seed)
    return np.stack([np.asarray(jq.pack_total_state(ja.Similarity(
        jnp.float32(rng.uniform(0.9, 1.1)), jnp.asarray(random_rotation(rng), jnp.float32),
        jnp.asarray(0.1 * rng.standard_normal(3), jnp.float32)))) for _ in range(b)])


def _hold_states(got, want):
    """The port's (B, 32) states against JAX's (B, 1, 32) float32 ones."""
    got = np.stack([state_to_jax(g[None]) for g in got]).astype(np.float64)
    for sl in (slice(1, 10), slice(10, 13), slice(14, 23), slice(23, 26)):  # R, t
        np.testing.assert_allclose(got[:, 0, sl], want[:, 0, sl], atol=1e-5)
    for k in (0, 13):  # s
        np.testing.assert_allclose(got[:, 0, k], want[:, 0, k], rtol=1e-5)
    np.testing.assert_allclose(got[:, 0, 26], want[:, 0, 26], rtol=1e-3)


@pytest.mark.parametrize("impl", ["vpu", "mxu"])
def test_nn_dense_batched_plain_is_each_pairs_plain(impl):
    """K1 (K10) with the pair axis: indices (pair-local) and distances
    bit-equal to ``nn_dense`` on each pair, exact ties to the lowest index
    (each model repeats its first rows), no launch counted."""
    s, m = (torch.tensor(a) for a in _clouds(1))
    m[:, 100:] = m[:, :70].clone()
    _build.reset_counts()
    idx, d2 = tn.nn_dense_batched(s, m, with_dist=True, distance_impl=impl)
    assert sum(_build.LAUNCHES.values()) == 0
    assert idx.shape == (B, 200) and idx.dtype == torch.int32 and bool((idx < 100).all())
    for b in range(B):
        i1, d1 = tn.nn_dense(s[b], m[b], with_dist=True, distance_impl=impl)
        assert torch.equal(idx[b], i1) and torch.equal(d2[b], d1)
    assert torch.equal(tn.nn_dense_batched(s, m, distance_impl=impl), idx)


def test_nn_dense_batched_matches_vmapped_jax_kernel():
    """K1's plain pair axis against ``vmap(closest_point_indices_pallas)``."""
    s, m = _clouds(2)
    want = jax.vmap(lambda a, c: jn.closest_point_indices_pallas(a, c, interpret=True))(
        jnp.asarray(s), jnp.asarray(m))
    got = tn.nn_dense_batched(torch.tensor(s), torch.tensor(m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nn_dense_batched_refuses_what_the_kernel_does_not_take():
    s, m = (torch.tensor(a) for a in _clouds(3))
    for args in ((s[0], m[0]), (s, m[:2]), (s.double(), m), (s, m[:, :0]),
                 (s.transpose(1, 2).contiguous().transpose(1, 2), m)):
        with pytest.raises(ValueError, match="nn_dense_batched"):
            tn.nn_dense_batched(*args)
    with pytest.raises(ValueError, match="distance_impl"):
        tn.nn_dense_batched(s, m, distance_impl="chunked")


def _partials(seed, b=B, rows=1):
    """(B, rows, 18) float64 partial sums of seeded centred correspondence
    sets (as ``test_torch_alignment.py``'s: the float32 closed-form
    residual of the JAX kernel keeps its digits) and the JAX kernel's
    (B, 1, 32) packed float32 statistics of the same."""
    rng = np.random.default_rng(seed)
    parts, packed = [], []
    for _ in range(b):
        p = rng.standard_normal((300, 3))
        p -= p.mean(0)
        y = 1.2 * p @ random_rotation(rng).T + 0.05 * rng.standard_normal((300, 3))
        y -= y.mean(0)
        pt, yt = torch.tensor(p), torch.tensor(y)
        parts.append(torch.cat([tq.pack_stats(ta.compute_alignment_stats(a, c))
                                for a, c in zip(pt.chunk(rows), yt.chunk(rows))]))
        packed.append(np.asarray(jq.pack_stats(ja.compute_alignment_stats(
            jnp.asarray(p, jnp.float32), jnp.asarray(y, jnp.float32)))))
    return torch.stack(parts), np.stack(packed)


@pytest.mark.parametrize("rows", [1, 5])
def test_qcp_step_batched_plain_is_each_pairs_plain(rows):
    """K2 with the pair axis, three steps from warm states, the middle pair
    done from the start: states, controls and error buffers bit-equal to
    B single-pair steps."""
    parts, _ = _partials(4, rows=rows)
    assert tq.pack_stats(ta.AlignmentStats(*(torch.zeros((B,) + sh) for sh in
                                             ((3,), (3,), (3, 3), (), (), ())))).shape \
        == (B, 1, tq.N_SUMS)
    state0 = torch.cat([state_from_jax(w) for w in _warm_states(5)])
    ctl0 = tq.new_loop_control(6, pairs=B)
    ctl0[1] = torch.tensor([2, 1, 6, 0], dtype=torch.int32)
    st, ctl, errs = state0.clone(), ctl0.clone(), tq.new_err_buffer(6, pairs=B)
    for _ in range(3):
        tq.qcp_step(parts, st, ctl, errs, threshold=1e-5, converge=False)
    assert ctl[:, 0].tolist() == [3, 2, 3] and ctl[1, 1] == 1
    for b in range(B):
        s1, c1, e1 = state0[b:b + 1].clone(), ctl0[b].clone(), tq.new_err_buffer(6)
        for _ in range(3):
            tq.qcp_step(parts[b], s1, c1, e1, threshold=1e-5, converge=False)
        assert torch.equal(st[b:b + 1], s1) and torch.equal(ctl[b], c1)
        assert torch.equal(torch.isnan(errs[b]), torch.isnan(e1))
        assert torch.equal(errs[b].nan_to_num(), e1.nan_to_num())


def test_qcp_step_batched_matches_vmapped_jax_kernel():
    """K2's plain pair axis against ``vmap(alignment_step_state_pallas)``."""
    parts, packed = _partials(6)
    prev = _warm_states(7)
    want = np.asarray(jax.vmap(lambda a, c: jq.alignment_step_state_pallas(
        a, c, interpret=True))(jnp.asarray(packed), jnp.asarray(prev)))
    st = torch.cat([state_from_jax(w) for w in prev])
    tq.qcp_step(parts, st, tq.new_loop_control(1, pairs=B), tq.new_err_buffer(1, pairs=B))
    _hold_states(st, want)


def test_qcp_step_batched_refuses_mismatched_pairs():
    parts, _ = _partials(8)
    st, ctl, errs = tq.identity_state(pairs=B), tq.new_loop_control(2, pairs=B), \
        tq.new_err_buffer(2, pairs=B)
    for args in ((parts[:2], st, ctl, errs), (parts, st[:2], ctl, errs),
                 (parts, st, ctl, errs[:2]), (parts[0], st, ctl, errs)):
        with pytest.raises(ValueError, match="qcp_step"):
            tq.qcp_step(*args)


def _prep_pairs(seed, b=B, n=200, m=170):
    s, m_ = _clouds(seed, b, n, m)
    return s, m_, tf.prepare_fused_inputs(torch.tensor(s), torch.tensor(m_))


def test_fused_step_batched_plain_is_each_pairs_plain():
    """K3 with the pair axis: the (B, N, 3) / (B, M, 4) layout is each
    pair's, and three iterations from warm states (the last pair done from
    the start) are bit-equal to B single-pair runs."""
    s, m, prep = _prep_pairs(9)
    assert prep.pairs == B and prep.p0.shape == (B, 200, 3) and prep.mt.shape == (B, 170, 4)
    state0 = torch.cat([state_from_jax(w) for w in _warm_states(10)])
    ctl0 = tq.new_loop_control(5, pairs=B)
    ctl0[-1] = torch.tensor([1, 1, 5, 0], dtype=torch.int32)
    st, ctl, errs = state0.clone(), ctl0.clone(), tq.new_err_buffer(5, pairs=B)
    _build.reset_counts()
    for _ in range(3):
        tf.fused_icp_step(prep, st, ctl, errs, threshold=1e-5, err_factor=2.0)
    assert sum(_build.LAUNCHES.values()) == 0
    for b in range(B):
        one = tf.prepare_fused_inputs(torch.tensor(s[b]), torch.tensor(m[b]))
        assert one.pairs is None
        assert torch.equal(one.p0, prep.p0[b]) and torch.equal(one.mt, prep.mt[b])
        s1, c1, e1 = state0[b:b + 1].clone(), ctl0[b].clone(), tq.new_err_buffer(5)
        for _ in range(3):
            tf.fused_icp_step(one, s1, c1, e1, threshold=1e-5, err_factor=2.0)
        assert torch.equal(st[b:b + 1], s1) and torch.equal(ctl[b], c1)
        assert torch.equal(errs[b].nan_to_num(), e1.nan_to_num())
    assert ctl[-1].tolist() == [1, 1, 5, 0]


def test_fused_step_batched_matches_vmapped_jax_kernel():
    """K3's plain pair axis against ``vmap(fused_icp_step)`` over the JAX
    package's ``prepare_fused_inputs``, one iteration from warm states."""
    s, m, prep = _prep_pairs(11)
    preps = [jf.prepare_fused_inputs(jnp.asarray(s[b]), jnp.asarray(m[b])) for b in range(B)]
    _, _, n, meta = preps[0]
    p0 = jnp.stack([p[0] for p in preps])
    mt = jnp.stack([p[1] for p in preps])
    prev = _warm_states(12)
    want = np.asarray(jax.vmap(lambda a, c, st: jf.fused_icp_step(
        (a, c, n, meta), st, interpret=True))(p0, mt, jnp.asarray(prev)))
    st = torch.cat([state_from_jax(w) for w in prev])
    tf.fused_icp_step(prep, st, tq.new_loop_control(1, pairs=B), tq.new_err_buffer(1, pairs=B),
                      threshold=1e-5, err_factor=2.0)
    _hold_states(st, want)


def test_fused_step_batched_refuses_single_pair_loop_tensors():
    _, _, prep = _prep_pairs(13)
    with pytest.raises(ValueError, match="fused_icp_step"):
        tf.fused_icp_step(prep, tq.identity_state(), tq.new_loop_control(2), tq.new_err_buffer(2))


def _rotation_inputs(seed, dtype, b=B):
    """(B, 3, 3) S and (B,) gp, gy of seeded centred pairs."""
    parts, _ = _partials(seed, b)
    a = parts[:, 0]
    n = a[:, 17]
    mu_p, mu_y = a[:, 9:12] / n[:, None], a[:, 12:15] / n[:, None]
    S = a[:, :9].reshape(-1, 3, 3) - n[:, None, None] * mu_p[:, :, None] * mu_y[:, None, :]
    gp = a[:, 15] - n * (mu_p * mu_p).sum(-1)
    gy = a[:, 16] - n * (mu_y * mu_y).sum(-1)
    return S.to(dtype).contiguous(), gp.to(dtype), gy.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_qcp_rotation_batched_plain_is_each_pairs_plain_and_jax(dtype):
    """K5 with the pair axis: ``qcp_rotation_from`` on (B, 3, 3) S and the
    packed entry on (B, 16) blocks, each pair bit-equal to its own call;
    against ``vmap(horn_rotation_pallas)`` (float32, interpret mode)."""
    S, gp, gy = _rotation_inputs(14, dtype)
    R, q, lam = tq.qcp_rotation_from(S, gp, gy)
    assert R.shape == (B, 3, 3) and R.dtype == dtype and q.shape == (B, 4) and lam.shape == (B,)
    packed = torch.cat([tq.pack_rotation_input(S[b], gp[b], gy[b]) for b in range(B)])
    out = tq.qcp_rotation(packed)
    assert out.shape == (B, tq.ROT_SLOTS)
    for b in range(B):
        one = tq.qcp_rotation_from(S[b], gp[b], gy[b])
        assert all(torch.equal(a[b], c) for a, c in zip((R, q, lam), one))
        assert torch.equal(out[b:b + 1], tq.qcp_rotation(packed[b:b + 1]))
    jR, jq_, jlam = jax.vmap(lambda a, c, d: jq.horn_rotation_pallas(a, c, d, interpret=True))(
        jnp.asarray(S.double().numpy(), jnp.float32), jnp.asarray(gp.double().numpy(), jnp.float32),
        jnp.asarray(gy.double().numpy(), jnp.float32))
    np.testing.assert_allclose(R.double().numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq_), atol=1e-5)
    np.testing.assert_allclose(lam.numpy(), np.asarray(jlam), rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_qcp_fused_solve_on_batched_statistics_is_b_single_solves(dtype):
    """``alignment_from_stats(solver="qcp_fused")`` on statistics with a pair
    axis (it refused them before the pair axis): its rotations are B
    single K5 solves of the centred statistics, bit for bit; the whole
    similarity is within 1e-10 (float64) / 1e-6 (float32) of B single
    ``alignment_from_stats`` calls (the centring's sums over the pair axis
    round in another order) and within float32 tolerances of the batched
    ``eigh`` solve."""
    rng = np.random.default_rng(15)
    p = torch.tensor(rng.standard_normal((B, 250, 3)), dtype=dtype)
    y = torch.stack([1.1 * p[b] @ torch.tensor(random_rotation(rng), dtype=dtype).T + 0.3 * b
                     for b in range(B)]) + 0.01 * torch.tensor(rng.standard_normal((B, 250, 3)),
                                                                dtype=dtype)
    stats = ta.compute_alignment_stats(p, y)
    got = ta.alignment_from_stats(stats, solver="qcp_fused")
    assert got.R.shape == (B, 3, 3) and got.t.shape == (B, 3) and got.s.shape == (B,)
    n = stats.n
    mu_p, mu_y = stats.sum_p / n[:, None], stats.sum_y / n[:, None]
    S = stats.sum_py - n[:, None, None] * (mu_p[:, :, None] * mu_y[:, None, :])
    gp = stats.sum_pp - n * (mu_p * mu_p).sum(-1)
    gy = stats.sum_yy - n * (mu_y * mu_y).sum(-1)
    tol = 1e-10 if dtype == torch.float64 else 1e-6
    for b in range(B):
        assert torch.equal(got.R[b], tq.qcp_rotation_from(S[b].contiguous(), gp[b], gy[b])[0])
        one = ta.alignment_from_stats(ta.AlignmentStats(*(v[b] for v in stats)),
                                      solver="qcp_fused")
        for a, c in zip(got, one):
            torch.testing.assert_close(a[b], c, rtol=tol, atol=tol)
    eigh = ta.alignment_from_stats(stats, solver="eigh")
    for a, c in zip(got, eigh):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5)


def _rot_z(th):
    return np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]],
                    np.float32)


def _batch(seed, bucketed):
    """B seeded pairs (each scene its model moved by its own small motion);
    bucketed: unequal true counts padded with ``batch_pairs``."""
    rng = np.random.default_rng(seed)
    pairs = []
    for b in range(B):
        nm = 150 + (23 * b if bucketed else 0)
        m = rng.standard_normal((nm, 3)).astype(np.float32)
        s = m[np.arange(nm - (11 * b if bucketed else 0))]
        pairs.append((m, (s @ _rot_z(0.04 * (b + 1)).T + 0.02 * b).astype(np.float32)))
    if bucketed:
        return tb.batch_pairs(pairs, quantum=64)
    return np.stack([m for m, _ in pairs]), np.stack([s for _, s in pairs]), None, None


# (nn_method, solver, trim, bucketed) of each JAX configuration that vmaps a
# kernel, but bf16; the kernels each takes in the port
CONFIGS = {
    "pallas_qcp_fused": ("pallas", "qcp_fused", 0.0, False),  # K3
    "pallas_qcp_fused_bucketed": ("pallas", "qcp_fused", 0.0, True),  # K1 + K2
    "pallas_qcp_fused_trimmed": ("pallas", "qcp_fused", 0.2, False),  # K1 + K2
    "pallas_eigh": ("pallas", "eigh", 0.0, False),  # K1
    "pallas_qcp_bucketed": ("pallas", "qcp", 0.0, True),  # K1
    "pallas_kabsch": ("pallas", "kabsch", 0.0, False),  # K1
    "bcast_qcp_fused": ("bcast", "qcp_fused", 0.0, False),  # K5
    "matmul_qcp_fused": ("matmul", "qcp_fused", 0.0, True),  # K5
}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_icp_batched_config_matches_jax_and_each_pairs_run(config):
    """Each configuration of ``icp_batched`` against JAX's on the same
    seeded batch (points within 1e-5, 5e-5 with ``qcp_fused``), and each
    pair against its own ``icp_fixed_iters`` (K3's path bit-equal; the
    others' points within 1e-5 and errors within rtol 1e-4 / atol 1e-7).
    Every result keeps the pair axis, each pair ran all its iterations."""
    nn, solver, trim, bucketed = CONFIGS[config]
    models, scenes, m_ns, s_ns = _batch(16 + len(config), bucketed)
    kw = dict(n_iters=6, solver=solver, nn_method=nn, trim_fraction=trim,
              with_scale=solver != "kabsch")
    _build.reset_counts()
    res = tb.icp_batched(models, scenes, scene_ns=s_ns, model_ns=m_ns, device=CPU, **kw)
    assert sum(_build.LAUNCHES.values()) == 0  # CPU tensors: the plain versions
    assert res.points.shape == scenes.shape and res.iters.tolist() == [6] * B
    assert res.err.shape == res.transform.s.shape == (B,) and res.transform.R.shape == (B, 3, 3)
    want = jb.icp_batched(jnp.asarray(models), jnp.asarray(scenes), scene_ns=s_ns,
                          model_ns=m_ns, **kw)
    tol = 5e-5 if solver == "qcp_fused" else 1e-5
    for b in range(B):
        n = scenes.shape[1] if s_ns is None else int(s_ns[b])
        np.testing.assert_allclose(res.points[b, :n].numpy(), np.asarray(want.points[b, :n]),
                                   atol=tol)
        np.testing.assert_allclose(res.transform.R[b].numpy(), np.asarray(want.transform.R[b]),
                                   atol=tol)
        one = icp_fixed_iters(models[b], scenes[b], device=CPU,
                              scene_n=None if s_ns is None else int(s_ns[b]),
                              model_n=None if m_ns is None else int(m_ns[b]), **kw)
        if config == "pallas_qcp_fused":
            assert torch.equal(res.points[b], one.points) and torch.equal(res.err[b], one.err)
            assert all(torch.equal(a[b], c) for a, c in zip(res.transform, one.transform))
        else:
            np.testing.assert_allclose(res.points[b, :n].numpy(), one.points[:n].numpy(),
                                       atol=1e-5)
            np.testing.assert_allclose(res.err[b].item(), one.err.item(), rtol=1e-4, atol=1e-7)


def test_icp_batched_kernel_path_with_no_iterations():
    """Zero iterations on the kernel path: the scenes as given, identity
    transforms, err +inf and 0 iterations a pair, as each pair's own run."""
    models, scenes, _, _ = _batch(30, False)
    res = tb.icp_batched(models, scenes, n_iters=0, solver="qcp_fused", nn_method="pallas",
                         device=CPU)
    one = icp_fixed_iters(models[0], scenes[0], n_iters=0, solver="qcp_fused",
                          nn_method="pallas", device=CPU)
    assert res.iters.tolist() == [0] * B and int(one.iters) == 0
    assert bool(torch.isinf(res.err).all()) and bool(torch.isinf(one.err))
    assert torch.equal(res.points, torch.tensor(scenes))
