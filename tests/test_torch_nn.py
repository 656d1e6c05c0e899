"""K1, K10 and K8 (dense nearest neighbour) plain versions vs the JAX
Pallas kernels.

The JAX kernels run in interpret mode, as their own tests run them on the
CPU.  K1 computes diff-squares float32 distances in JAX's order, so the
indices must be exactly equal, duplicates (lowest index) and ragged sizes
included; K10 (``distance_impl="mxu"``) the expansion form, whose indices
must equal JAX's and whose distances lie within 4 ulp of the expansion's
terms (XLA on the CPU may contract the dot).
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


@pytest.mark.parametrize("case", ["ties", "nan", "m31", "m1"])
def test_chunked_plain_ties_nan_and_short_models_match_jax(case):
    """K8's plain version against JAX's chunked kernel where the card's
    kernel splits work: ties across lanes, within a lane's group of rows 32
    apart and across model chunks (rows j duplicated at j + 17, j + 32,
    j + 96 and j + 512: a chunk of the card's kernel is whole 512-row
    stages); a NaN model row (never wins) near either end; fewer model rows
    than lanes (m = 31, m = 1)."""
    rng = np.random.default_rng(13)
    n, m = (37, {"m31": 31, "m1": 1}[case]) if case in ("m31", "m1") else (40, 600)
    model = (2.0 * rng.standard_normal((m, 3))).astype(np.float32)
    scene = rng.standard_normal((n, 3)).astype(np.float32)
    if case == "ties":
        for off in (17, 32, 96, 512):
            model[off:off + 8] = model[:8]
        scene[:8] = model[:8] + np.float32(1e-3)
    elif case == "nan":
        model[5, 1] = np.nan
        model[m - 2, 0] = np.nan
    got = nn_dense.nn_chunked_plain(torch.tensor(scene), torch.tensor(model)).numpy()
    np.testing.assert_array_equal(got, _jax_chunked(scene, model, 8, 128))
    np.testing.assert_array_equal(got, nn_dense.nn_dense_plain(torch.tensor(scene),
                                                               torch.tensor(model)).numpy())
    if case == "ties":
        np.testing.assert_array_equal(got[:8], np.arange(8))
    if case == "nan":
        assert not np.isin(got, [5, m - 2]).any()


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
        nn_dense.nn_dense(s, m, distance_impl="bogus")  # a truly unknown form


def _jax_mxu(scene, model, tm=4096):
    """JAX's ``"mxu"`` form of ``_nn_kernel``: indices, and distances with
    ``|p|^2`` added back (interpret mode)."""
    idx, d2 = nn_pallas._closest_pallas(
        jnp.asarray(scene), jnp.asarray(model), scene_tile=256, model_tile=tm,
        interpret=True, with_dist=True, distance_impl="mxu")
    return np.asarray(idx), np.asarray(d2)


def _mxu_tol(scene, model):
    """4 ulp of the larger of the two terms of the expansion, a row: XLA on
    the CPU may contract the dot, the port rounds every operation."""
    pn = (scene.astype(np.float64) ** 2).sum(1)
    return 4 * 2.0 ** -24 * ((model.astype(np.float64) ** 2).sum(1).max() + pn)


@pytest.mark.parametrize("n,m", [(5, 1), (100, 300), (257, 950), (1000, 4097)])
def test_mxu_matches_jax_kernel(n, m):
    """K10's plain version (``distance_impl="mxu"``) against the JAX
    kernel's ``"mxu"`` form: equal indices, distances within 4 ulp."""
    scene, model = _clouds(n + 2 * m, n, m)
    s, mo = torch.tensor(scene), torch.tensor(model)
    got = nn_dense.closest_point_indices_dense(s, mo, distance_impl="mxu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax_idx(scene, model, distance_impl="mxu"))
    idx, d2 = nn_dense.nn_dense(s, mo, with_dist=True, distance_impl="mxu")
    jidx, jd2 = _jax_mxu(scene, model)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    assert (np.abs(d2.numpy().astype(np.float64) - jd2) <= _mxu_tol(scene, model)).all()


def test_mxu_ties_go_to_lowest_index_and_distances_may_be_negative():
    """Duplicated model rows across JAX's tiles: the lowest index wins in
    both; far from the origin every expansion distance is negative and the
    returned ``d + |p|^2`` is a near-zero squared distance, unclamped."""
    rng = np.random.default_rng(11)
    base = rng.standard_normal((300, 3)).astype(np.float32)
    model = np.concatenate([base, base, base[:50]])
    scene = base[::3] + np.float32(1e-3)
    got = nn_dense.closest_point_indices_dense(torch.tensor(scene), torch.tensor(model),
                                               distance_impl="mxu").numpy()
    np.testing.assert_array_equal(got, _jax_idx(scene, model, model_tile=256, distance_impl="mxu"))
    assert (got < 300).all()
    far_m, far_s = model + np.float32(40.0), scene + np.float32(40.0)
    idx, d2 = nn_dense.nn_dense(torch.tensor(far_s), torch.tensor(far_m), with_dist=True,
                                distance_impl="mxu")
    jidx, jd2 = _jax_mxu(far_s, far_m, tm=256)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    assert (np.abs(d2.numpy().astype(np.float64) - jd2) <= _mxu_tol(far_s, far_m)).all()
    mt, st = torch.tensor(far_m), torch.tensor(far_s)
    mn = (mt[:, 0] * mt[:, 0] + mt[:, 1] * mt[:, 1]) + mt[:, 2] * mt[:, 2]
    c = (st[:, None, 0] * mt[None, :, 0] + st[:, None, 1] * mt[None, :, 1]) \
        + st[:, None, 2] * mt[None, :, 2]
    assert bool(((mn[None, :] - 2.0 * c) < 0).all())


def test_mxu_row_without_a_finite_distance_gets_index_0_and_inf():
    """K10 keeps K1's rule: a scene row with no distance below +inf (here a
    NaN row: NaN never wins) gets index 0 and +inf, not +inf + |p|^2."""
    scene, model = _clouds(9, 7, 200)
    scene[3] = np.nan
    idx, d2 = nn_dense.nn_dense(torch.tensor(scene), torch.tensor(model), with_dist=True,
                                distance_impl="mxu")
    assert int(idx[3]) == 0 and float(d2[3]) == float("inf")
    rows = [0, 1, 2, 4, 5, 6]
    jidx, _ = _jax_mxu(scene[rows], model)
    np.testing.assert_array_equal(idx.numpy()[rows], jidx)


def test_mxu_is_counted_apart_and_cpu_takes_the_plain_version():
    scene, model = _clouds(12, 40, 90)
    s, m = torch.tensor(scene), torch.tensor(model)
    _build.reset_counts()
    got = nn_dense.nn_dense(s, m, with_dist=True, distance_impl="mxu")
    want = nn_dense.nn_dense_plain(s, m, with_dist=True, distance_impl="mxu")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _build.LAUNCHES["nn_dense_mxu"] == 0 and _build.LAUNCHES["nn_dense"] == 0
    with pytest.raises(ValueError, match="distance_impl"):
        nn_dense.nn_dense_plain(s, m, distance_impl="chunked")


def _nan_model(seed=3, n=40, m=300, row=7):
    """(scene, model with one NaN coordinate in ``row``, the same model with
    that row moved far away): a NaN row must give what the far row gives."""
    scene, model = _clouds(seed, n, m)
    model[row, 2] = np.nan
    far = model.copy()
    far[row] = 1e6
    return scene, model, far


@pytest.mark.parametrize("impl", ["vpu", "mxu"])
def test_dense_plain_never_returns_a_nan_row(impl):
    """K1's (``"vpu"``) and K10's (``"mxu"``) plain versions follow their
    kernel's strict ``d < best`` fold: a NaN model row never wins.  JAX's
    kernel returns 2147483647 for every point here in both forms, an index
    out of range: its NaN ``jnp.min`` matches no lane (a fault of the
    reference, ROADMAP R5), which the port does not copy."""
    scene, model, far = _nan_model()
    s = torch.tensor(scene)
    idx, d2 = nn_dense.nn_dense_plain(s, torch.tensor(model), with_dist=True, distance_impl=impl)
    want, wd2 = nn_dense.nn_dense_plain(s, torch.tensor(far), with_dist=True, distance_impl=impl)
    assert not bool((idx == 7).any())
    assert torch.equal(idx, want) and torch.equal(d2, wd2)
    assert (_jax_idx(scene, model, distance_impl=impl) == 2147483647).all()  # R5


def test_dense_plain_nan_scene_row_gets_index_0_and_inf():
    scene, model = _clouds(5, 9, 120)
    scene[2, 0] = np.nan
    idx, d2 = nn_dense.nn_dense_plain(torch.tensor(scene), torch.tensor(model), with_dist=True)
    assert int(idx[2]) == 0 and float(d2[2]) == float("inf")


def test_chunked_plain_never_returns_a_nan_row():
    """K8's plain version: a NaN distance never wins in a lane (the
    kernel's strict ``d < best``), so a NaN model row gives what a far row
    gives, as JAX's chunked kernel does; a NaN scene row gets index 0."""
    scene, model, far = _nan_model(seed=4, n=48)
    scene[5, 1] = np.nan
    got = nn_dense.nn_chunked_plain(torch.tensor(scene), torch.tensor(model))
    want = nn_dense.nn_chunked_plain(torch.tensor(scene), torch.tensor(far))
    assert torch.equal(got, want) and int(got[5]) == 0
    rows = np.arange(48) != 5
    np.testing.assert_array_equal(got.numpy()[rows],
                                  _jax_chunked(scene[rows], model, 16, 128))


@pytest.mark.parametrize("method", ["bcast", "matmul"])
def test_plain_methods_follow_jax_argmin_with_nan(method):
    """``ops/distance.py``'s ``bcast`` and ``matmul`` have no kernel: they
    are the JAX package's XLA paths, whose ``argmin`` lets a NaN distance
    win (the first NaN's index), as ``torch.argmin`` does.  The sweep of
    the NaN-wins fault leaves them so: they equal JAX's, NaN rows included."""
    from icp_tpu.ops import distance as jdist

    scene, model, _ = _nan_model()
    scene[4, 1] = np.nan
    got = closest_point_indices(torch.tensor(scene), torch.tensor(model), method=method)
    want = np.asarray(jdist.closest_point_indices(jnp.asarray(scene), jnp.asarray(model),
                                                  method=method))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 7).any()
