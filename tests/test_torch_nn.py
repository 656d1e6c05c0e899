"""K1 (dense nearest neighbour) plain version vs the JAX Pallas kernel.

The JAX kernel runs in interpret mode, as its own tests run it on the CPU.
Both compute diff-squares float32 distances in the same order, so the
indices must be exactly equal, duplicates (lowest index) and ragged sizes
included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_tpu.kernels import nn_pallas
from icp_tpu_torch.kernels import _build
from icp_tpu_torch.kernels import nn_dense
from icp_tpu_torch.ops.distance import closest_point_indices


def _clouds(seed, n, m):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3)).astype(np.float32),
            (2.0 * rng.standard_normal((m, 3))).astype(np.float32))


def _jax_idx(scene, model, **kw):
    return np.asarray(nn_pallas.closest_point_indices_pallas(
        jnp.asarray(scene), jnp.asarray(model), interpret=True, **kw))


@pytest.mark.parametrize("n,m", [(5, 1), (100, 300), (257, 950), (1000, 4097)])
def test_dense_matches_jax_kernel(n, m):
    scene, model = _clouds(n + m, n, m)
    got = nn_dense.closest_point_indices_dense(torch.tensor(scene), torch.tensor(model))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax_idx(scene, model))


def test_dense_ties_go_to_lowest_index():
    rng = np.random.default_rng(1)
    base = rng.standard_normal((300, 3)).astype(np.float32)
    model = np.concatenate([base, base, base[:50]])  # duplicates across tiles
    scene = base[::3] + np.float32(1e-3)
    got = nn_dense.closest_point_indices_dense(torch.tensor(scene), torch.tensor(model)).numpy()
    np.testing.assert_array_equal(got, _jax_idx(scene, model, model_tile=256))
    assert (got < 300).all()


def test_dense_distances_match_jax_kernel():
    scene, model = _clouds(2, 130, 700)
    idx, d2 = nn_dense.nn_dense(torch.tensor(scene), torch.tensor(model), with_dist=True)
    jidx, jd2 = nn_pallas.closest_point_with_distances_pallas(
        jnp.asarray(scene), jnp.asarray(model), interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    # XLA's CPU backend contracts d + diff * diff into a multiply-add, the
    # port rounds each operation: the distances differ by up to 2 ulp.
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=3e-7)


def test_dense_row_without_a_finite_distance_gets_index_0_and_inf():
    """A scene row whose every distance overflows: index 0 and d2 = +inf,
    as the JAX kernel gives (K1's chunks emit no key for it)."""
    scene, model = _clouds(8, 9, 300)
    scene[4] = [3e38, -3e38, 3e38]
    idx, d2 = nn_dense.nn_dense(torch.tensor(scene), torch.tensor(model), with_dist=True)
    jidx, jd2 = nn_pallas.closest_point_with_distances_pallas(
        jnp.asarray(scene), jnp.asarray(model), interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert int(idx[4]) == 0 and np.isinf(float(d2[4])) and np.isinf(float(jd2[4]))


@pytest.mark.parametrize("method", ["bcast", "matmul"])
def test_plain_methods_agree_with_kernel_path(method):
    scene, model = _clouds(3, 200, 500)
    s, m = torch.tensor(scene), torch.tensor(model)
    np.testing.assert_array_equal(closest_point_indices(s, m, method=method).numpy(),
                                  closest_point_indices(s, m, method="pallas").numpy())


def test_cpu_tensors_take_the_plain_version():
    scene, model = _clouds(4, 64, 64)
    _build.reset_counts()
    got = nn_dense.nn_dense(torch.tensor(scene), torch.tensor(model))
    want = nn_dense.nn_dense_plain(torch.tensor(scene), torch.tensor(model))
    assert torch.equal(got, want)
    assert _build.LAUNCHES["nn_dense"] == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    scene, model = _clouds(5, 8, 8)
    with pytest.raises(ValueError, match="float32"):
        nn_dense.nn_dense(torch.tensor(scene, dtype=torch.float64), torch.tensor(model))
    with pytest.raises(ValueError, match="contiguous"):
        nn_dense.nn_dense(torch.tensor(scene).T.contiguous().T, torch.tensor(model))
    with pytest.raises(ValueError, match="empty"):
        nn_dense.nn_dense(torch.tensor(scene), torch.zeros((0, 3)))


def _jax_chunked(scene, model, tn, tm):
    return np.asarray(nn_pallas._closest_pallas(
        jnp.asarray(scene), jnp.asarray(model), scene_tile=tn, model_tile=tm,
        interpret=True, with_dist=False, distance_impl="chunked"))


@pytest.mark.parametrize("n,m,tn,tm", [(40, 300, 16, 128), (100, 1000, 32, 256),
                                       (257, 129, 64, 128)])
def test_chunked_matches_jax_chunked_kernel(n, m, tn, tm):
    scene, model = _clouds(n * m, n, m)
    got = nn_dense.closest_point_indices_dense(torch.tensor(scene), torch.tensor(model),
                                               distance_impl="chunked")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax_chunked(scene, model, tn, tm))
    np.testing.assert_array_equal(got.numpy(), _jax_idx(scene, model))  # equal to K1


def test_chunked_ties_go_to_lowest_index_across_tiles_and_lanes():
    rng = np.random.default_rng(7)
    p = rng.standard_normal((16, 3)).astype(np.float32)
    ones = np.ones((300, 3), np.float32)
    got = nn_dense.nn_dense(torch.tensor(p), torch.tensor(ones), distance_impl="chunked")
    np.testing.assert_array_equal(got.numpy(), _jax_chunked(p, ones, 8, 128))
    assert (got == 0).all()
    base = rng.standard_normal((97, 3)).astype(np.float32)
    model = np.concatenate([base, base, base])  # a row's copies sit on other lanes
    scene = base + np.float32(1e-3)
    got = nn_dense.nn_chunked_plain(torch.tensor(scene), torch.tensor(model)).numpy()
    np.testing.assert_array_equal(got, _jax_chunked(scene, model, 32, 128))
    np.testing.assert_array_equal(got, nn_dense.nn_dense_plain(
        torch.tensor(scene), torch.tensor(model)).numpy())
    assert (got < 97).all()


def test_chunked_is_indices_only_and_cpu_takes_the_plain_version():
    scene, model = _clouds(6, 64, 70)
    s, m = torch.tensor(scene), torch.tensor(model)
    _build.reset_counts()
    assert torch.equal(nn_dense.nn_dense(s, m, distance_impl="chunked"),
                       nn_dense.nn_chunked_plain(s, m))
    assert _build.LAUNCHES["nn_chunked"] == 0 and _build.LAUNCHES["nn_dense"] == 0
    with pytest.raises(ValueError, match="indices only"):
        nn_dense.nn_dense(s, m, with_dist=True, distance_impl="chunked")
    with pytest.raises(ValueError, match="distance_impl"):
        nn_dense.nn_dense(s, m, distance_impl="mxu")
