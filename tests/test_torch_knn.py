"""The kNN kernels' plain versions (K6, K7) and the port's kNN search vs the
JAX package.

Inputs are made with numpy from a seed and handed to both packages; the JAX
kernels run in interpret mode, as the JAX tests run them on the CPU.
Indices must be equal, with exact ties and the per-tile overflow fallback
included; squared distances agree within 4 ulp, because XLA's CPU backend
contracts multiply-adds and the port does not.  Inside the port the grid
search must equal the dense kNN exactly, distances included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_tpu.kernels import knn_grid as jkg
from icp_tpu.kernels import nn_grid as jg
from icp_tpu.kernels.knn_pallas import knn_pallas
from icp_tpu_torch.kernels import _build
from icp_tpu_torch.kernels import knn_dense as tkd
from icp_tpu_torch.kernels import knn_grid as tkg
from icp_tpu_torch.kernels import nn_grid as tg
from icp_tpu_torch.utils.convert import model_grid_from_jax


def _cloud(seed, n, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal((n, 3))).astype(np.float32)


def _within_ulps(got, want, ulps=4):
    got = np.asarray(got, np.float32).astype(np.float64)
    want = np.asarray(want, np.float32).astype(np.float64)
    tol = ulps * np.spacing(np.maximum(np.abs(got), np.abs(want)).astype(np.float32))
    assert np.all(np.abs(got - want) <= tol), float(np.abs(got - want).max())


@pytest.mark.parametrize("k", [1, 5, 17, 32])
def test_knn_dense_plain_matches_jax(k):
    q, p = _cloud(1, 300), _cloud(2, 700, 1.2)
    jd, ji = knn_pallas(jnp.asarray(q), jnp.asarray(p), k, query_tile=64, point_tile=256)
    d2, idx = tkd.knn_dense(torch.tensor(q), torch.tensor(p), k)
    assert d2.shape == idx.shape == (300, k) and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    _within_ulps(d2.numpy(), jd)
    assert np.all(np.diff(d2.numpy(), axis=1) >= 0)


def test_knn_dense_lattice_ties_go_to_the_lowest_index():
    """An integer lattice, every point twice: each query has many neighbours
    at exactly equal float32 distances, and the lowest index must win."""
    g = np.arange(6, dtype=np.float32)
    lattice = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts = np.concatenate([lattice[::-1], lattice])  # 432 points, duplicated
    q = np.concatenate([lattice[::7], lattice[::11] + 0.5]).astype(np.float32)
    d_np = ((q[:, None].astype(np.float64) - pts[None]) ** 2).sum(-1)
    want = np.argsort(d_np, axis=1, kind="stable")[:, :17]
    jd, ji = knn_pallas(jnp.asarray(q), jnp.asarray(pts), 17, query_tile=32, point_tile=128)
    d2, idx = tkd.knn_dense(torch.tensor(q), torch.tensor(pts), 17)
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(jd))  # small integers: exact


def test_knn_k_exceeds_points_raises():
    p = torch.tensor(_cloud(3, 5))
    with pytest.raises(ValueError, match="exceeds point count"):
        tkd.knn_dense(p, p, 6)
    grid = tg.build_model_grid(p, target_tile=128)
    with pytest.raises(ValueError, match="exceeds point count"):
        tkg.knn_grid(p, grid, 6)
    with pytest.raises(ValueError, match="outside 1..32"):
        tkd.knn_dense(torch.tensor(_cloud(4, 40)), torch.tensor(_cloud(5, 40)), 33)


def _grid_case(seed, n_pts=1500, n_query=700):
    pts = _cloud(seed, n_pts)
    query = _cloud(seed + 1, n_query, 0.9)
    jgrid = jg.build_model_grid(jnp.asarray(pts), target_tile=128)
    return pts, query, jgrid, model_grid_from_jax(jgrid)


@pytest.mark.parametrize("k,max_candidates", [(8, 16), (17, 16), (5, 1)])
def test_knn_grid_matches_jax_and_dense(k, max_candidates):
    """max_candidates=1 forces the per-tile fallback (every tile folds all)."""
    pts, query, jgrid, tgrid = _grid_case(10 + k)
    jd, ji = jkg.knn_grid(jnp.asarray(query), jgrid, k, scene_tile=64,
                          max_candidates=max_candidates)
    _build.reset_counts()
    d2, idx = tkg.knn_grid(torch.tensor(query), tgrid, k, scene_tile=64,
                           max_candidates=max_candidates)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    _within_ulps(d2.numpy(), jd)
    dd, di = tkd.knn_dense(torch.tensor(query), torch.tensor(pts), k)
    assert torch.equal(idx, di) and torch.equal(d2, dd)
    assert _build.LAUNCHES["knn_grid"] == 0  # CPU tensors take the plain version


def test_knn_grid_carried_grid_equals_the_ports_own():
    pts, query, _, tgrid = _grid_case(30)
    own = tg.build_model_grid(torch.tensor(pts), target_tile=128)
    assert torch.equal(own.tiles, tgrid.tiles) and own.model_tile == tgrid.model_tile
    a = tkg.knn_grid(torch.tensor(query), own, 6, scene_tile=32)
    b = tkg.knn_grid(torch.tensor(query), tgrid, 6, scene_tile=32)
    assert torch.equal(a[1], b[1])


def test_knn_grid_duplicates_tie_to_the_lowest_original_index():
    base = _cloud(40, 300)
    pts = np.concatenate([base, base])  # each point twice, in other kd tiles
    grid = tg.build_model_grid(torch.tensor(pts), target_tile=128)
    _, idx = tkg.knn_grid(torch.tensor(base[:64]), grid, 6, scene_tile=32, max_candidates=32)
    _, ji = knn_pallas(jnp.asarray(base[:64]), jnp.asarray(pts), 6, query_tile=64,
                       point_tile=128)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(idx.numpy()[:, 0], np.arange(64))
    np.testing.assert_array_equal(idx.numpy()[:, 1], np.arange(64) + 300)


def test_knn_worklist_plain_seed_phase_matches_jax():
    """The seed launch alone: each query tile's c0 nearest boxes."""
    pts, query, jgrid, tgrid = _grid_case(50, n_query=256)
    k, tn = 9, 64
    q8 = jnp.zeros((256, 8), jnp.float32).at[:, :3].set(jnp.asarray(query))
    bd2 = jg.tile_box_dists(q8, jgrid, scene_tile=tn)
    order = jnp.argsort(bd2, axis=1)[:, :2].astype(jnp.int32)
    counts = jnp.full((4, 1), 2, jnp.int32)
    jd, ji = jkg._run_worklist(q8, order, counts, jgrid, k, scene_tile=tn, interpret=True)
    tbd2 = tg.tile_box_dists(torch.tensor(query), tgrid, scene_tile=tn)
    np.testing.assert_array_equal(tbd2.numpy(), np.asarray(bd2))
    torder, tcounts = tkg.seed_table(tbd2, k, tgrid.model_tile)
    np.testing.assert_array_equal(torder.numpy(), np.asarray(order))
    assert tcounts.tolist() == [2] * 4
    d2, idx = tkg.knn_worklist(torder, tcounts, torch.tensor(query), tgrid.tiles, tn, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    _within_ulps(d2.numpy(), jd)
