"""The port's batched registration (``engine/batched.py``) against the JAX
package's, the counterparts of ``tests/test_batched.py``'s five cases.

Inputs are made with numpy from a seed and handed to both packages; the
JAX kernels run as its own tests run them on the CPU.  Tolerances: points
within 1e-5 of JAX's (float32 solves of the same fixed point, as JAX's own
test holds points against the models), errors within rtol 1e-4 / atol
1e-7 of the per-pair engine (float32 sums in another order), except where
a case says bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_tpu.engine import batched as jb
from icp_tpu.engine.icp import icp_fixed_iters as jax_fixed
from icp_tpu_torch.engine import batched as tb
from icp_tpu_torch.engine.icp import icp_fixed_iters
from icp_tpu_torch.kernels import _build
from icp_tpu_torch.ops.padding import pad_to_bucket

CPU = "cpu"


def _rot_z(th):
    return np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]],
                    np.float32)


def _pairs(seed, B=4, N=200):
    models = np.random.default_rng(seed).standard_normal((B, N, 3)).astype(np.float32)
    scenes = models @ _rot_z(0.1).T + np.array([0.1, -0.05, 0.2], np.float32)
    return models, scenes


def test_batched_matches_per_pair_and_jax():
    models, scenes = _pairs(1)
    res = tb.icp_batched(models, scenes, n_iters=20, device=CPU)
    want = jb.icp_batched(jnp.asarray(models), jnp.asarray(scenes), n_iters=20)
    assert res.points.shape == scenes.shape and res.iters.tolist() == [20] * 4
    np.testing.assert_allclose(res.points.numpy(), models, atol=1e-5)
    np.testing.assert_allclose(res.points.numpy(), np.asarray(want.points), atol=1e-5)
    np.testing.assert_allclose(res.transform.R.numpy(), np.asarray(want.transform.R), atol=1e-5)
    assert (res.err.numpy() < 1e-5).all()
    for b in range(4):
        single = icp_fixed_iters(models[b], scenes[b], n_iters=20, device=CPU)
        np.testing.assert_allclose(res.points[b].numpy(), single.points.numpy(), atol=1e-6)
        np.testing.assert_allclose(res.err[b].item(), single.err.item(), rtol=1e-4, atol=1e-7)


def test_batched_pallas_fused_path_is_each_pairs_own_run():
    """``nn_method="pallas"``, ``solver="qcp_fused"``: each pair runs the
    fused path (K3's plain version on the CPU) through ``icp_fixed_iters``,
    bit-equal to its own run; points within 5e-5 of the models, as JAX's
    test holds its fused path."""
    models, scenes = _pairs(2)
    _build.reset_counts()
    res = tb.icp_batched(models, scenes, n_iters=20, solver="qcp_fused", nn_method="pallas",
                         device=CPU)
    assert sum(_build.LAUNCHES.values()) == 0  # CPU tensors: plain versions
    want = jb.icp_batched(jnp.asarray(models), jnp.asarray(scenes), n_iters=20,
                          solver="qcp_fused", nn_method="pallas")
    np.testing.assert_allclose(res.points.numpy(), models, atol=5e-5)
    np.testing.assert_allclose(res.points.numpy(), np.asarray(want.points), atol=5e-5)
    for b in range(4):
        single = icp_fixed_iters(models[b], scenes[b], n_iters=20, solver="qcp_fused",
                                 nn_method="pallas", device=CPU)
        assert torch.equal(res.points[b], single.points)
        assert torch.equal(res.transform.R[b], single.transform.R)


def _unequal_pairs(seed):
    rng = np.random.default_rng(seed)
    pairs = []
    for k, (nm, ns) in enumerate([(96, 150), (128, 97), (150, 150), (101, 133)]):
        m = rng.standard_normal((nm, 3)).astype(np.float32)
        src = m[np.arange(ns) % nm]
        pairs.append((m, src @ _rot_z(0.04 * (k + 1)).T
                      + np.array([0.02 * k, -0.01, 0.03], np.float32)))
    return pairs


def test_batched_bucketed_unequal_pairs():
    """Unequal pairs in one bucket: each equals the single-pair bucketed
    engine, and JAX's batched run."""
    pairs = _unequal_pairs(3)
    models, scenes, m_ns, s_ns = tb.batch_pairs(pairs, quantum=64)
    jm, js, jmn, jsn = jb.batch_pairs(pairs, quantum=64)
    np.testing.assert_array_equal(models, jm)
    np.testing.assert_array_equal(scenes, js)
    assert m_ns.tolist() == jmn.tolist() and s_ns.tolist() == jsn.tolist()
    res = tb.icp_batched(models, scenes, n_iters=15, scene_ns=s_ns, model_ns=m_ns, device=CPU)
    want = jb.icp_batched(jnp.asarray(models), jnp.asarray(scenes), n_iters=15,
                          scene_ns=s_ns, model_ns=m_ns)
    assert res.err.shape == (4,)
    for b, (m, s) in enumerate(pairs):
        n = len(s)
        single = icp_fixed_iters(models[b], scenes[b], n_iters=15, scene_n=int(s_ns[b]),
                                 model_n=int(m_ns[b]), device=CPU)
        np.testing.assert_allclose(res.err[b].item(), single.err.item(), rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(res.points[b, :n].numpy(), single.points[:n].numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(res.points[b, :n].numpy(), np.asarray(want.points[b, :n]),
                                   atol=1e-5)
        np.testing.assert_allclose(res.err[b].item(), float(want.err[b]), rtol=1e-4, atol=1e-7)
        d = res.points[b, :n].numpy() - m[np.arange(n) % len(m)]
        assert float(np.sqrt((d ** 2).sum(1)).mean()) < 1e-2


@pytest.mark.parametrize("trim", [0.0, 0.2])
def test_register_chain_batched_matches_sequential(trim):
    """A 4-pair unequal-count chain in one batch against the sequential
    bucketed engine pair by pair, and against JAX's batched chain; with
    ``trim=0.2`` each pair's quantile is the single-pair engine's."""
    rng = np.random.default_rng(4)
    base = rng.standard_normal((160, 3)).astype(np.float32)
    clouds = [(base[np.arange(n) % 160] @ _rot_z(0.03 * k).T + 0.02 * k).astype(np.float32)
              for k, n in enumerate((160, 120, 140, 100, 130))]
    res = tb.register_chain_batched(clouds, n_iters=12, quantum=64, trim_fraction=trim,
                                    device=CPU)
    want = jb.register_chain_batched(clouds, n_iters=12, quantum=64, trim_fraction=trim)
    assert len(res) == 4
    for b in range(4):
        mp, mn = pad_to_bucket(clouds[b], n_pad=192)
        sp, sn = pad_to_bucket(clouds[b + 1], n_pad=192)
        single = icp_fixed_iters(mp, sp, n_iters=12, scene_n=sn, model_n=mn,
                                 trim_fraction=trim, device=CPU)
        np.testing.assert_allclose(res[b].transform.R.numpy(), single.transform.R.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(res[b].transform.t.numpy(), single.transform.t.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(res[b].transform.R.numpy(), np.asarray(want[b].transform.R),
                                   atol=1e-5)
        np.testing.assert_allclose(res[b].transform.t.numpy(), np.asarray(want[b].transform.t),
                                   atol=1e-5)
        assert res[b].points.shape == (len(clouds[b + 1]), 3)
        jsingle = jax_fixed(jnp.asarray(mp), jnp.asarray(sp), n_iters=12, scene_n=sn,
                            model_n=mn, trim_fraction=trim)
        np.testing.assert_allclose(res[b].err.item(), float(jsingle.err), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("solver", ["eigh", "qcp", "kabsch"])
def test_batched_heterogeneous_transforms(solver):
    """Each pair its own transform, every batched solver: all recovered,
    as JAX's batched run recovers them."""
    rng = np.random.default_rng(5)
    models = rng.standard_normal((3, 150, 3)).astype(np.float32)
    scenes = np.stack([models[b] @ _rot_z(0.05 * (b + 1)).T + 0.1 * (b + 1) for b in range(3)])
    res = tb.icp_batched(models, scenes.astype(np.float32), n_iters=30, solver=solver,
                         with_scale=solver != "kabsch", device=CPU)
    np.testing.assert_allclose(res.points.numpy(), models, atol=1e-4)
    want = jb.icp_batched(jnp.asarray(models), jnp.asarray(scenes.astype(np.float32)),
                          n_iters=30, solver=solver, with_scale=solver != "kabsch")
    np.testing.assert_allclose(res.points.numpy(), np.asarray(want.points), atol=1e-4)


def test_batch_pairs_refuses_an_empty_list():
    """JAX's ``batch_pairs([])`` dies in a bare ``max()`` (ROADMAP R2); the
    port names the problem."""
    with pytest.raises(ValueError, match="no pairs"):
        tb.batch_pairs([])


def test_batched_auto_resolves_as_the_config_does():
    """``"auto"`` on the CPU is ``bcast``/``eigh`` (ROADMAP R3: the batch
    goes through ``ICPConfig``'s dispatch), the same run as the default."""
    models, scenes = _pairs(6, B=2, N=64)
    a = tb.icp_batched(models, scenes, n_iters=5, solver="auto", nn_method="auto", device=CPU)
    b = tb.icp_batched(models, scenes, n_iters=5, device=CPU)
    assert torch.equal(a.points, b.points) and torch.equal(a.err, b.err)
