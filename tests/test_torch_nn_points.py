"""K11 (``closest_points_and_targets_dense``: the nearest model index and
the model point itself) against the JAX kernel's ``with_points`` form.

JAX's ``closest_points_and_targets_pallas`` runs in interpret mode, as its
own test (``tests/test_pallas.py::test_with_points_matches_gather``) runs
it; its one-hot gather at HIGHEST is exact on finite input, so the
indices must be equal and the points bit-equal, over several model tiles,
ragged scene sizes and duplicated model rows.  A scene row with a NaN
coordinate follows the port's rule (ROADMAP, known differences): index 0
and ``model[0]``, where JAX gives 2147483647 and a zero point.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_tpu.kernels.nn_pallas import closest_points_and_targets_pallas
from icp_tpu_torch.kernels import _build
from icp_tpu_torch.kernels.nn_dense import (
    closest_point_indices_dense,
    closest_points_and_targets_dense,
    nn_dense_points_plain,
)


def _clouds(seed, n, m):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3)).astype(np.float32),
            (2.0 * rng.standard_normal((m, 3))).astype(np.float32))


def _jax(scene, model, **kw):
    idx, y = closest_points_and_targets_pallas(jnp.asarray(scene), jnp.asarray(model),
                                               interpret=True, **kw)
    return np.asarray(idx), np.asarray(y)


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float32).view(np.int32)


def _port(scene, model):
    idx, y = closest_points_and_targets_dense(torch.tensor(scene), torch.tensor(model))
    assert idx.dtype == torch.int32 and y.dtype == torch.float32
    assert tuple(y.shape) == (scene.shape[0], 3)
    return idx.numpy(), y.numpy()


@pytest.mark.parametrize("n,m,scene_tile", [(77, 300, 256), (513, 1000, 256), (40, 1000, 16)])
def test_points_match_jax_kernel(n, m, scene_tile):
    """Several 128-row model tiles, ragged N: JAX's indices, its points bit
    for bit, and ``y == model[idx]``."""
    scene, model = _clouds(n + m, n, m)
    idx, y = _port(scene, model)
    jidx, jy = _jax(scene, model, scene_tile=scene_tile, model_tile=128)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(_bits(y), _bits(jy))
    np.testing.assert_array_equal(_bits(y), _bits(model[idx]))


def test_points_ties_go_to_the_lowest_index():
    """Every model row three times, across tiles: the first copy wins, in
    JAX's kernel and in the port."""
    rng = np.random.default_rng(3)
    base = rng.standard_normal((300, 3)).astype(np.float32)
    model = np.concatenate([base, base, base[:50]])
    scene = base[::3] + np.float32(1e-3)
    idx, y = _port(scene, model)
    jidx, jy = _jax(scene, model, model_tile=128)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(_bits(y), _bits(jy))
    assert (idx < 300).all()


def test_points_indices_are_k1s_and_inputs_are_cast():
    """float64 and strided clouds are cast to contiguous float32, as
    ``closest_point_indices_dense`` casts them: the same indices."""
    scene, model = _clouds(5, 200, 450)
    s64 = torch.tensor(scene, dtype=torch.float64)
    m_strided = torch.tensor(np.concatenate([model, model], axis=1))[:, :3]
    assert not m_strided.is_contiguous()
    idx, y = closest_points_and_targets_dense(s64, m_strided)
    want = closest_point_indices_dense(torch.tensor(scene), torch.tensor(model))
    assert torch.equal(idx, want)
    assert torch.equal(y, torch.tensor(model)[want.long()])


def test_points_row_without_a_finite_distance():
    """A row whose every distance overflows gets index 0 and model[0] in
    both packages; a NaN row gets the port's index 0 and model[0] (JAX's
    kernel: 2147483647 and a zero point, ROADMAP R5)."""
    scene, model = _clouds(8, 9, 300)
    scene[4] = [3e38, -3e38, 3e38]
    scene[6] = [np.nan, 0.0, 0.0]
    idx, y = _port(scene, model)
    jidx, jy = _jax(scene, model, model_tile=128)
    finite = np.arange(9) != 6
    np.testing.assert_array_equal(idx[finite], jidx[finite])
    np.testing.assert_array_equal(_bits(y[finite]), _bits(jy[finite]))
    assert idx[4] == 0 and idx[6] == 0
    np.testing.assert_array_equal(_bits(y[[4, 6]]), _bits(model[[0, 0]]))
    assert jidx[6] == 2**31 - 1 and not jy[6].any()


def test_cpu_tensors_launch_nothing():
    scene, model = _clouds(4, 64, 130)
    _build.reset_counts()
    got = closest_points_and_targets_dense(torch.tensor(scene), torch.tensor(model))
    want = nn_dense_points_plain(torch.tensor(scene), torch.tensor(model))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _build.LAUNCHES["nn_dense_points"] == 0
    assert sum(_build.LAUNCHES.values()) == 0
