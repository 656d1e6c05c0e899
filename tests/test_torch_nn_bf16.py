"""K9 (bf16-prefiltered NN) plain version vs the JAX Pallas kernel.

The JAX kernel runs in interpret mode, as its own tests run it.  The
function is approximate by design, and XLA's CPU backend may contract and
reorder the cross term's padded dot, so ``d~`` can differ by an ulp between
the packages and flip an index inside the bf16 band.  The tests hold what
the kernel promises: the reported distance is exact for the reported index
and bounds the true NN distance; a certified index is the exact NN; on
data with margins (and ``center=False``, which leaves the float32 mean out)
the indices agree.  Kernel against plain, bit for bit, is a card test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_tpu.kernels import nn_bf16 as j_bf16
from icp_tpu_torch.kernels import _build, nn_bf16
from icp_tpu_torch.ops.distance import closest_point_indices
from tests import oracle


def _jax(p, m, **kw):
    kw.setdefault("scene_tile", 32)
    kw.setdefault("model_tile", 256)
    idx, dex, cert = j_bf16.closest_point_indices_bf16(
        jnp.asarray(p), jnp.asarray(m), interpret=True, **kw)
    return np.asarray(idx), np.asarray(dex), np.asarray(cert)


def _port(p, m, **kw):
    idx, dex, cert = nn_bf16.closest_point_indices_bf16(torch.tensor(p), torch.tensor(m), **kw)
    assert idx.dtype == torch.int32 and dex.dtype == torch.float32 and cert.dtype == torch.bool
    return idx.numpy(), dex.numpy(), cert.numpy()


def _clouds(seed, n, m, offset=0.0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((n, 3)) + offset).astype(np.float32),
            (rng.standard_normal((m, 3)) + offset).astype(np.float32))


@pytest.mark.parametrize("center", [False, True])
def test_reported_distance_is_exact_and_bounds_the_nn(center):
    p, m = _clouds(0, 100, 1000)
    idx, dex, _ = _port(p, m, center=center)
    jidx, jdex, _ = _jax(p, m, center=center)
    want = oracle.closest_indices(p.astype(np.float64), m.astype(np.float64))
    d_true = np.sum((p - m[want]) ** 2, axis=1)
    for i, d in ((idx, dex), (jidx, jdex)):
        np.testing.assert_allclose(d, np.sum((p - m[i]) ** 2, axis=1), rtol=1e-6, atol=1e-7)
        assert np.all(d >= d_true - 1e-7)


def _sites(seed, n, side):
    """A jittered lattice of side^3 sites (spacing 1) and n scene points,
    half beside a site (margins above the bf16 band), half anywhere."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(float(side))] * 3), -1).reshape(-1, 3)
    m = g + 0.02 * rng.standard_normal(g.shape)
    near = g[rng.integers(0, len(g), n // 2)] + 0.05 * rng.standard_normal((n // 2, 3))
    far = rng.uniform(0.0, side - 1.0, (n - n // 2, 3))
    return np.concatenate([near, far]).astype(np.float32), m.astype(np.float32)


@pytest.mark.parametrize("seed,n,side", [(1, 128, 6), (2, 300, 5)])
def test_indices_agree_with_jax_where_both_certify(seed, n, side):
    p, mm = _sites(seed, n, side)
    want = oracle.closest_indices(p.astype(np.float64), mm.astype(np.float64))
    idx, _, cert = _port(p, mm)
    jidx, _, jcert = _jax(p, mm, model_tile=128)
    both = cert & jcert
    assert 0 < both.sum() < n
    np.testing.assert_array_equal(idx[both], jidx[both])
    np.testing.assert_array_equal(idx[cert], want[cert])  # certified means exact
    np.testing.assert_array_equal(jidx[jcert], want[jcert])


def test_indices_agree_with_jax_uncentred():
    p, m = _clouds(3, 1000, 700)
    idx, _, _ = _port(p, m, center=False)
    jidx, _, _ = _jax(p, m, center=False)
    assert (idx == jidx).mean() >= 0.99


def test_lattice_is_fully_certified_in_both():
    rng = np.random.default_rng(4)
    m = np.stack(np.meshgrid(*[np.arange(4.0)] * 3), -1).reshape(-1, 3).astype(np.float32)
    sel = rng.integers(0, len(m), 40)
    p = (m[sel] + 0.01 * rng.standard_normal((40, 3))).astype(np.float32)
    for idx, _, cert in (_port(p, m), _jax(p, m, scene_tile=8, model_tile=128)):
        assert cert.all()
        np.testing.assert_array_equal(idx, sel)


def test_centering_shrinks_the_bound_and_matches_jax():
    p, m = _clouds(5, 64, 256, offset=100.0)
    tp, tm = torch.tensor(p), torch.tensor(m)
    b_raw = nn_bf16.cross_term_bound(tp, tm)
    jb_raw = np.float32(j_bf16.cross_term_bound(jnp.asarray(p), jnp.asarray(m)))
    assert b_raw.dtype == torch.float32
    assert abs(float(b_raw) - float(jb_raw)) <= float(np.spacing(jb_raw))
    c = tm.mean(0)
    assert float(nn_bf16.cross_term_bound(tp - c, tm - c)) < float(b_raw) / 100
    assert _port(p, m, center=True)[2].sum() >= _port(p, m, center=False)[2].sum()


def test_duplicate_model_row_gives_the_lowest_index_and_no_certificate():
    rng = np.random.default_rng(6)
    m = np.stack(np.meshgrid(*[np.arange(3.0)] * 3), -1).reshape(-1, 3).astype(np.float32)
    m = np.concatenate([m, m[5:6]])  # row 27 repeats row 5
    p = (m[5] + 0.01 * rng.standard_normal((8, 3))).astype(np.float32)
    idx, best, second, dex = (t.numpy() for t in nn_bf16.nn_bf16(torch.tensor(p),
                                                                  torch.tensor(m)))
    assert (idx == 5).all() and np.array_equal(best, second)
    for i, _, cert in (_port(p, m), _jax(p, m, scene_tile=8, model_tile=128)):
        assert (i == 5).all() and not cert.any()


def test_single_model_row_certifies():
    p, m = _clouds(7, 10, 1)
    idx, best, second, _ = nn_bf16.nn_bf16(torch.tensor(p), torch.tensor(m))
    assert (idx == 0).all() and torch.isinf(second).all() and torch.isfinite(best).all()
    assert _port(p, m)[2].all() and _jax(p, m)[2].all()


def test_ops_dispatches_bf16_and_cpu_takes_the_plain_version():
    p, m = _clouds(8, 32, 128)
    _build.reset_counts()
    got = closest_point_indices(torch.tensor(p), torch.tensor(m), method="bf16")
    assert got.dtype == torch.int32 and got.shape == (32,)
    np.testing.assert_array_equal(got.numpy(), _port(p, m)[0])
    assert _build.LAUNCHES["nn_bf16"] == 0
    with pytest.raises(ValueError, match="float32"):
        nn_bf16.nn_bf16(torch.tensor(p, dtype=torch.float64), torch.tensor(m))
    with pytest.raises(ValueError, match="empty"):
        nn_bf16.nn_bf16(torch.tensor(p), torch.zeros((0, 3)))


def _merge(u, v):
    """The kernel's order-free merge of two (best, second, idx) triples over
    disjoint column sets (``csrc/nn_bf16.cu``): the least best, the lowest
    index among equal bests, second = min(max(b1, b2), min(s1, s2))."""
    (bu, su, iu), (bv, sv, iv) = u, v
    take = (bv < bu) | ((bv == bu) & (iv < iu))
    return (torch.where(take, bv, bu), torch.minimum(torch.maximum(bu, bv), torch.minimum(su, sv)),
            torch.where(take, iv, iu))


@pytest.mark.parametrize("chunk,seed", [(128, 0), (256, 1), (1, 2)])
def test_chunk_triples_merge_to_the_plain_version_in_any_order(chunk, seed):
    """A torch mirror of the kernel's chunk merge: the plain version's
    triple of each model chunk, joined in a seeded random order, equals the
    plain version over the whole model, duplicated rows in other chunks
    (ties on best and second, with multiplicity) included."""
    rng = np.random.default_rng(seed)
    p, m = _clouds(20 + seed, 150, 700)
    m[400:450] = m[100:150]  # copies of rows 100-149, chunks away
    m[699] = m[3]
    tp, tm = torch.tensor(p), torch.tensor(m)
    norm = (tm[:, 0] * tm[:, 0] + tm[:, 1] * tm[:, 1]) + tm[:, 2] * tm[:, 2]
    pb, mb = tp.bfloat16().float(), tm.bfloat16().float()
    parts = []
    for lo in range(0, 700, chunk):
        cross = (pb[:, None, 0] * mb[None, lo:lo + chunk, 0]
                 + pb[:, None, 1] * mb[None, lo:lo + chunk, 1]) + pb[:, None, 2] * mb[None, lo:lo + chunk, 2]
        d = norm[None, lo:lo + chunk] - 2.0 * cross
        best, arg = torch.min(d, dim=1)
        second = d.scatter(1, arg[:, None], float("inf")).amin(1)
        parts.append((best, second, arg + lo))
    order = rng.permutation(len(parts))
    got = parts[order[0]]
    for k in order[1:]:
        got = _merge(got, parts[k])
    idx, best, second, _ = nn_bf16.nn_bf16_plain(tp, tm)
    assert torch.equal(got[0], best) and torch.equal(got[1], second)
    assert torch.equal(got[2].to(torch.int32), idx)
    assert bool((second == best).any())  # some ties with multiplicity were merged
