"""K9 with a pair axis (``nn_bf16_batched``, the counterpart of JAX's
``vmap`` over the bf16 ``pallas_call``) and ``icp_batched(nn_method="bf16")``
on it, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the JAX
kernel runs under ``jax.vmap`` in interpret mode, as the JAX package's own
tests run it on the CPU.  Here the wrapper takes its plain version (CPU
tensors), ``nn_bf16_plain`` pair by pair, so each pair is bit-equal to B
separate calls.  Against JAX the function is held as
``test_torch_nn_bf16.py`` holds the single pair: XLA may round the cross
term otherwise by an ulp, which can flip an index inside the bf16 band, so
indices agree where both certify and certified rows are the exact nearest
neighbour.  The registrations run on jittered lattices where every row
certifies before and after (so every index is the exact nearest
neighbour): points within 1e-5 of JAX's (5e-5 with ``qcp_fused``, whose
JAX solve is float32), and of each pair's own ``icp_fixed_iters`` within
1e-5, errors within rtol 1e-4 / atol 1e-7 (float32 sums over a pair axis).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_tpu.engine import batched as jb
from icp_tpu.kernels import nn_bf16 as j_bf16
from icp_tpu_torch.engine import batched as tb
from icp_tpu_torch.engine.icp import icp_fixed_iters
from icp_tpu_torch.kernels import _build
from icp_tpu_torch.kernels import nn_bf16 as tn
from tests import oracle

B = 3
CPU = "cpu"


def _clouds(seed, b=B, n=120, m=90, offset=0.0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, n, 3)) + offset).astype(np.float32),
            (1.5 * rng.standard_normal((b, m, 3)) + offset).astype(np.float32))


@pytest.mark.parametrize("b", [1, B])
def test_nn_bf16_batched_plain_is_each_pairs_plain(b):
    """The four outputs of every pair bit-equal to ``nn_bf16`` on that pair
    (the plain version), ties to the lowest index (each model repeats its
    first rows), no launch counted; the entry point centres each pair as
    the single pair is centred, bit for bit."""
    s, m = (torch.tensor(a) for a in _clouds(1, b, offset=3.0))
    m[:, 60:] = m[:, :30].clone()
    _build.reset_counts()
    outs = tn.nn_bf16_batched(s, m)
    assert all(t.shape == (b, 120) for t in outs) and outs[0].dtype == torch.int32
    assert bool((outs[0] < 60).all())
    for k in range(b):
        one = tn.nn_bf16(s[k], m[k])
        assert all(torch.equal(a[k], c) for a, c in zip(outs, one))
        assert all(torch.equal(a[k], c) for a, c in zip(tn.nn_bf16_batched_plain(s, m), one))
    idx = tn.nearest_indices_bf16_batched(s, m)
    got = tb.closest_point_indices_batched(s, m, "bf16")
    assert got.dtype == torch.int64 and torch.equal(got, idx.long())
    for k in range(b):
        assert torch.equal(tn.bf16_centres(m)[k], m[k].mean(0))
        assert torch.equal(idx[k], tn.nearest_indices_bf16(s[k].clone(), m[k].clone()))
    assert sum(_build.LAUNCHES.values()) == 0


def _sites(seed, b, n, side):
    """B jittered lattices of side^3 sites (spacing 1), each with n scene
    points, half beside a site (margins above the bf16 band), half
    anywhere."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(float(side))] * 3), -1).reshape(-1, 3)
    scenes, models = [], []
    for _ in range(b):
        models.append(g + 0.02 * rng.standard_normal(g.shape))
        near = g[rng.integers(0, len(g), n // 2)] + 0.05 * rng.standard_normal((n // 2, 3))
        far = rng.uniform(0.0, side - 1.0, (n - n // 2, 3))
        scenes.append(np.concatenate([near, far]))
    return np.stack(scenes).astype(np.float32), np.stack(models).astype(np.float32)


def test_nn_bf16_batched_matches_vmapped_jax_kernel():
    """Per pair against ``vmap(closest_point_indices_bf16)`` (centred):
    indices equal where both certify, certified rows the exact nearest
    neighbour in both, the exact distance that of the reported index."""
    s, m = _sites(2, B, 160, 5)
    jidx, jdex, jcert = (np.asarray(a) for a in jax.vmap(
        lambda a, c: j_bf16.closest_point_indices_bf16(a, c, scene_tile=32, model_tile=128,
                                                       interpret=True))(
        jnp.asarray(s), jnp.asarray(m)))
    ts, tm = torch.tensor(s), torch.tensor(m)
    c = tn.bf16_centres(tm)[:, None]
    sc, mc = (ts - c).contiguous(), (tm - c).contiguous()
    idx, best, second, dex = tn.nn_bf16_batched(sc, mc)
    assert torch.equal(tn.nearest_indices_bf16_batched(ts, tm), idx)
    for k in range(B):
        cert = ((second[k] - best[k]) > 2.0 * tn.cross_term_bound(sc[k], mc[k])).numpy()
        want = oracle.closest_indices(s[k].astype(np.float64), m[k].astype(np.float64))
        both = cert & jcert[k]
        assert 0 < both.sum() < len(cert)
        np.testing.assert_array_equal(idx[k].numpy()[both], jidx[k][both])
        np.testing.assert_array_equal(idx[k].numpy()[cert], want[cert])
        np.testing.assert_array_equal(jidx[k][jcert[k]], want[jcert[k]])
        np.testing.assert_allclose(jdex[k], np.sum((s[k] - m[k][jidx[k]]) ** 2, axis=1),
                                   rtol=1e-6, atol=1e-7)


def _rot_z(th):
    return np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]],
                    np.float32)


def _lattice_batch(seed, bucketed):
    """B pairs on jittered 4^3 lattices (spacing 1): each scene its model's
    rows with noise, turned about the lattice's centre and shifted by a
    small motion of its own (at most 0.2 of a spacing), so every scene row
    lies well inside its site's cell; bucketed: unequal true counts padded
    with ``batch_pairs``."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(4.0)] * 3), -1).reshape(-1, 3)
    pairs = []
    for b in range(B):
        m = (g + 0.02 * rng.standard_normal(g.shape)).astype(np.float32)
        keep = len(g) - (5 * b if bucketed else 0)
        s = m[:keep] + 0.01 * rng.standard_normal((keep, 3)) - 1.5  # about the centre
        s = (s @ _rot_z(0.02 * (b + 1)).T + 1.5 + 0.02 * (b + 1)).astype(np.float32)
        pairs.append((m[:len(g) - (3 * b if bucketed else 0)], s))
    if bucketed:
        return tb.batch_pairs(pairs, quantum=16)
    return np.stack([m for m, _ in pairs]), np.stack([s for _, s in pairs]), None, None


def _all_certified(points, models, s_ns, m_ns):
    for k in range(B):
        n = points.shape[1] if s_ns is None else int(s_ns[k])
        mn = models.shape[1] if m_ns is None else int(m_ns[k])
        _, _, cert = tn.closest_point_indices_bf16(torch.as_tensor(points[k, :n]),
                                                   torch.as_tensor(models[k, :mn]))
        assert bool(cert.all())


# (solver, trim, bucketed)
CONFIGS = {
    "eigh": ("eigh", 0.0, False),
    "eigh_bucketed": ("eigh", 0.0, True),
    "eigh_trimmed": ("eigh", 0.2, False),
    "qcp_fused": ("qcp_fused", 0.0, False),
    "qcp_fused_bucketed": ("qcp_fused", 0.0, True),
    "qcp_fused_trimmed": ("qcp_fused", 0.2, False),
}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_icp_batched_bf16_matches_jax_and_each_pairs_run(config):
    """``icp_batched(nn_method="bf16")`` against JAX's on the same seeded
    lattice batch (points and R within 1e-5, 5e-5 with ``qcp_fused``) and
    each pair against its own ``icp_fixed_iters`` (points within 1e-5,
    errors within rtol 1e-4 / atol 1e-7); every row certified at the start
    and at the end, so every index is the exact nearest neighbour."""
    solver, trim, bucketed = CONFIGS[config]
    models, scenes, m_ns, s_ns = _lattice_batch(40 + len(config), bucketed)
    _all_certified(scenes, models, s_ns, m_ns)
    kw = dict(n_iters=4, solver=solver, nn_method="bf16", trim_fraction=trim)
    _build.reset_counts()
    res = tb.icp_batched(models, scenes, scene_ns=s_ns, model_ns=m_ns, device=CPU, **kw)
    assert sum(_build.LAUNCHES.values()) == 0  # CPU tensors: the plain versions
    assert res.points.shape == scenes.shape and res.iters.tolist() == [4] * B
    _all_certified(res.points.numpy(), models, s_ns, m_ns)
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
        np.testing.assert_allclose(res.points[b, :n].numpy(), one.points[:n].numpy(), atol=1e-5)
        np.testing.assert_allclose(res.err[b].item(), one.err.item(), rtol=1e-4, atol=1e-7)


def test_nn_bf16_batched_refuses_what_the_kernel_does_not_take():
    """As K1's pair axis: mismatched pair counts, a non-float32, 2-D or
    non-contiguous input, and an empty model raise on the CPU too."""
    s, m = (torch.tensor(a) for a in _clouds(3))
    for args in ((s[0], m[0]), (s, m[:2]), (s.double(), m), (s, m.double()), (s, m[:, :0]),
                 (s.transpose(1, 2).contiguous().transpose(1, 2), m)):
        with pytest.raises(ValueError, match="nn_bf16_batched"):
            tn.nn_bf16_batched(*args)
