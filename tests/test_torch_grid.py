"""The grid path's torch side and K4's plain version vs the JAX package.

``kd_order``, ``build_model_grid``, the candidate table and the engine's
scene preparation must be bit-equal to JAX's (both sort stably in float32).
K4's plain version must give the JAX work-list kernel's (interpret mode)
indices and matched points exactly; the distances agree to 2 ulp because
XLA's CPU backend contracts multiply-adds and the port does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_tpu.engine import grid as jg_engine
from icp_tpu.kernels import nn_grid as jg
from icp_tpu_torch.engine import grid as tg_engine
from icp_tpu_torch.kernels import nn_grid as tg
from icp_tpu_torch.utils.convert import model_grid_from_jax


def _sphere(n, seed, noise=0.01):
    r = np.random.default_rng(seed)
    v = r.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (v + noise * r.standard_normal((n, 3))).astype(np.float32)


@pytest.mark.parametrize("n,levels,padded", [(64, 3, False), (1024, 5, False),
                                             (768, 4, True)])
def test_kd_order_bit_equal(n, levels, padded):
    pts = np.random.default_rng(n).standard_normal((n, 3)).astype(np.float32)
    pts[::7] = pts[3]  # duplicate keys: the sort must be stable on both sides
    real = np.arange(n) < n - 37 if padded else None
    want = jg.kd_order(jnp.asarray(pts), levels,
                       real=None if real is None else jnp.asarray(real))
    got = tg.kd_order(torch.tensor(pts), levels,
                      real=None if real is None else torch.tensor(real))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,target", [(2903, 1024), (5000, 256)])
def test_build_model_grid_bit_equal(m, target):
    model = _sphere(m, seed=m)
    want = jg.build_model_grid(jnp.asarray(model), target_tile=target)
    got = tg.build_model_grid(torch.tensor(model), target_tile=target)
    assert got.model_tile == want.model_tile
    np.testing.assert_array_equal(got.tiles.numpy(),
                                  np.asarray(want.tiles_t)[:, :4, :].transpose(0, 2, 1))
    np.testing.assert_array_equal(got.tile_lo.numpy(), np.asarray(want.tile_lo))
    np.testing.assert_array_equal(got.tile_hi.numpy(), np.asarray(want.tile_hi))


def _grid_case(seed=0, n=900, m=1500):
    model = _sphere(m, seed=seed + 1)
    scene = _sphere(n, seed=seed + 2) * 1.02 + np.float32([0.01, -0.02, 0.005])
    perm = np.asarray(jg.kd_order(jnp.asarray(scene[:n - n % 4]), 2))
    scene = scene[:n - n % 4][perm]
    jgrid = jg.build_model_grid(jnp.asarray(model), target_tile=128)
    tgrid = tg.build_model_grid(torch.tensor(model), target_tile=128)
    idx0 = jg.initial_bound_indices(jnp.asarray(scene), jnp.asarray(model), stride=8,
                                    interpret=True)
    u = np.asarray(jg.bound_from_indices(jnp.asarray(scene), jgrid, idx0))
    return scene, model, jgrid, tgrid, u


def test_bounds_and_candidates_equal():
    scene, model, jgrid, tgrid, u = _grid_case()
    tidx0 = tg.initial_bound_indices(torch.tensor(scene), torch.tensor(model), stride=8)
    tu = tg.bound_from_indices(torch.tensor(scene), tgrid, tidx0)
    np.testing.assert_allclose(tu.numpy(), u, rtol=3e-7)
    tn = 60  # 900 scene rows: 15 tiles
    jc, jn, jo = jg._candidates(jnp.asarray(scene), jnp.asarray(u), jgrid,
                                scene_tile=tn, cap=8)
    tc, tcount, to = tg.candidates(torch.tensor(scene), torch.tensor(u), tgrid,
                                   scene_tile=tn, cap=8)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tcount.numpy(), np.asarray(jn))
    assert bool(to) == bool(jo)


@pytest.mark.parametrize("cap,cut", [(8, False), (3, False), (1, False), (8, True)])
def test_near_tiles_are_the_least_box_distance(cap, cut):
    """K4's near pass: ``candidates`` keeps its outputs (JAX's), and
    ``near_tiles`` gives each scene tile the ``NEAR_TILES`` model tiles of
    least box distance, ties by the boxes' centres, each kept only where
    it is a candidate or the tile is past the capacity (else -1: ``cut``
    gives the first five scene tiles negative bounds, so no candidate)."""
    scene, _, jgrid, tgrid, u = _grid_case(seed=14)
    if cut:
        u = np.where(np.arange(u.shape[0]) < 300, np.float32(-1.0), u)
    p, tu = torch.tensor(scene), torch.tensor(u)
    cand, counts, over = tg.candidates(p, tu, tgrid, scene_tile=60, cap=cap)
    near = tg.near_tiles(p, tgrid, cand, counts, scene_tile=60)
    jc, jn, jo = jg._candidates(jnp.asarray(scene), jnp.asarray(u), jgrid, scene_tile=60, cap=cap)
    np.testing.assert_array_equal(cand.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jn))
    assert bool(over) == bool(jo)
    nj = tgrid.tiles.shape[0]
    assert near.dtype == torch.int32 and near.shape == (counts.shape[0], tg.NEAR_TILES)
    dists = tg.tile_box_dists(p, tgrid, scene_tile=60)
    t_mid = (tgrid.tile_lo + tgrid.tile_hi) * 0.5
    for ti, cnt in enumerate(counts.tolist()):
        tile = p[ti * 60:(ti + 1) * 60]
        mid = tg.sqnorm_rows((tile.amin(0) + tile.amax(0)) * 0.5 - t_mid)
        order = sorted(range(nj), key=lambda j: (float(dists[ti, j]), float(mid[j]), j))
        kept = set(range(nj)) if cnt > cap else set(cand[ti, :cnt].tolist())
        want = [j if j in kept else -1 for j in order[:tg.NEAR_TILES]]
        assert near[ti].tolist() == want, (ti, cnt)
    assert (near >= 0).any() and bool((near[:5] == -1).all()) == cut


@pytest.mark.parametrize("max_candidates", [16, 1])
def test_pruned_matches_jax_kernel(max_candidates):
    scene, model, jgrid, tgrid, u = _grid_case(seed=3)
    jidx, jy, _, jd2, jover = jg.closest_point_indices_pruned(
        jnp.asarray(scene), jgrid, jnp.asarray(u), scene_tile=60,
        max_candidates=max_candidates, interpret=True)
    idx, y, pl, d2, over = tg.closest_point_indices_pruned(
        torch.tensor(scene), tgrid, torch.tensor(u), scene_tile=60,
        max_candidates=max_candidates)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=3e-7)
    assert bool(over) == bool(jover) and pl is None
    brute = ((scene[:, None] - model[None]) ** 2).sum(-1).argmin(1)
    np.testing.assert_array_equal(idx.numpy(), brute)


def test_pruned_ties_go_to_lowest_original_index():
    base = _sphere(300, seed=4)
    model = np.concatenate([base, base])  # every point twice, in other kd tiles
    scene = base[:100]
    tgrid = tg.build_model_grid(torch.tensor(model), target_tile=128)
    idx0 = tg.initial_bound_indices(torch.tensor(scene), torch.tensor(model), stride=4)
    u = tg.bound_from_indices(torch.tensor(scene), tgrid, idx0)
    idx, _, _, _ = tg.closest_point_indices_grid(torch.tensor(scene), tgrid, u,
                                                 scene_tile=32, max_candidates=32)
    np.testing.assert_array_equal(idx.numpy(), np.arange(100))


def test_prepare_scene_matches_jax():
    scene = _sphere(1000, seed=5)
    jp, jw, jinv, jtn, jperm = jg_engine._prepare_scene(jnp.asarray(scene), 256)
    tp, tw, tinv, ttn, tperm = tg_engine._prepare_scene(torch.tensor(scene), 256)
    assert ttn == jtn
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))


@pytest.mark.parametrize("width", [3, 4])
def test_build_model_grid_payload_matches_jax(width):
    model = _sphere(900, seed=6)
    payload = np.random.default_rng(7).standard_normal((900, width))
    jgrid = jg.build_model_grid(jnp.asarray(model), target_tile=128,
                                payload=jnp.asarray(payload))
    tgrid = tg.build_model_grid(torch.tensor(model), target_tile=128,
                                payload=torch.tensor(payload))
    assert tgrid.payload_width == width and tgrid.payload.shape == tgrid.tiles.shape
    want = np.asarray(jgrid.tiles_t)[:, 4:4 + width, :].transpose(0, 2, 1)
    np.testing.assert_array_equal(tgrid.payload[..., :width].numpy(), want)
    assert not tgrid.payload[..., width:].any()
    carried = model_grid_from_jax(jgrid)
    assert torch.equal(carried.payload, tgrid.payload) and torch.equal(carried.tiles, tgrid.tiles)


@pytest.mark.parametrize("max_candidates", [16, 1])
def test_payload_slot_matches_jax_kernel(max_candidates):
    """K4's plain version emits the winner's payload row, as the JAX
    work-list kernel's payload sublanes do (interpret mode)."""
    scene, model, _, _, u = _grid_case(seed=8)
    normals = np.random.default_rng(9).standard_normal((model.shape[0], 3)).astype(np.float32)
    jgrid = jg.build_model_grid(jnp.asarray(model), target_tile=128,
                                payload=jnp.asarray(normals))
    tgrid = model_grid_from_jax(jgrid)
    jidx, jy, jpl, _ = jg.closest_point_indices_grid(
        jnp.asarray(scene), jgrid, jnp.asarray(u), scene_tile=60,
        max_candidates=max_candidates, interpret=True)
    idx, y, pl, _ = tg.closest_point_indices_grid(
        torch.tensor(scene), tgrid, torch.tensor(u), scene_tile=60,
        max_candidates=max_candidates)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert pl.shape == (scene.shape[0], 3)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jpl))
    np.testing.assert_array_equal(pl.numpy(), normals[idx.numpy()])


@pytest.mark.parametrize("m,target", [(900, 128), (2903, 1024), (5000, 256)])
def test_kd_row_inverts_the_kd_permutation(m, target):
    """``ModelGrid.kd_row`` maps each original index to its kd row: the same
    on the port's own grid and on one carried from JAX's ``build_model_grid``,
    and the tile row it names holds that point and that index."""
    model = _sphere(m, seed=m + 1)
    own = tg.build_model_grid(torch.tensor(model), target_tile=target)
    carried = model_grid_from_jax(jg.build_model_grid(jnp.asarray(model), target_tile=target))
    assert own.kd_row.dtype == torch.int32 and own.kd_row.shape == (m,)
    assert torch.equal(own.kd_row, carried.kd_row)
    rows = own.tiles.reshape(-1, 4)[own.kd_row.long()]
    np.testing.assert_array_equal(rows[:, 3].numpy(), np.arange(m, dtype=np.float32))
    np.testing.assert_array_equal(rows[:, :3].numpy(), model)


def _decode_item(cand, counts, offsets, item):
    """(scene tile, model tile) of work item ``item``, as K4's fold kernel
    decodes it: the last scene tile whose first item is <= item, then the
    model tile at ``item - first`` of its fold list."""
    ti = int(torch.searchsorted(offsets[:-1], torch.tensor(item, dtype=offsets.dtype),
                                right=True)) - 1
    c = item - int(offsets[ti])
    return ti, c if int(counts[ti]) > cand.shape[1] else int(cand[ti, c])


@pytest.mark.parametrize("cap", [16, 3, 1])
def test_work_items_cover_each_fold_list(cap):
    """K4's work items, on JAX's own candidate table: each scene tile's
    items, decoded as the kernel decodes them, are its fold list (its
    candidates, or every tile past the capacity), one model tile each."""
    scene, _, jgrid, tgrid, u = _grid_case(seed=11)
    jc, jn, _ = jg._candidates(jnp.asarray(scene), jnp.asarray(u), jgrid, scene_tile=60, cap=cap)
    cand, counts = torch.tensor(np.asarray(jc)), torch.tensor(np.asarray(jn))
    nj = tgrid.tiles.shape[0]
    offsets = tg.work_item_offsets(counts, cap, nj)
    assert offsets.dtype == torch.int32 and offsets.shape == (counts.shape[0] + 1,)
    folds = [tg.tile_ids(cand, nj, ti, c).tolist() for ti, c in enumerate(counts.tolist())]
    assert int(offsets[-1]) == sum(map(len, folds))
    got = [[] for _ in folds]
    for item in range(int(offsets[-1])):
        ti, j = _decode_item(cand, counts, offsets, item)
        got[ti].append(j)
    assert got == folds
    if cap == 1:
        assert (counts > cap).any()  # the straggler tiles are cut too


def test_plain_reads_the_winner_through_kd_row():
    """K4's plain version reads the winner's point and payload row through
    ``kd_row`` (the kernel's epilogue lookup): they are the model point and
    the normal of the original index it returns."""
    scene, model, _, _, u = _grid_case(seed=12)
    normals = np.random.default_rng(13).standard_normal((model.shape[0], 3))
    grid = tg.build_model_grid(torch.tensor(model), target_tile=128,
                               payload=torch.tensor(normals))
    cand, counts, _ = tg.candidates(torch.tensor(scene), torch.tensor(u), grid,
                                    scene_tile=60, cap=4)
    _, idx, y, pl = tg.nn_grid(cand, counts, torch.tensor(scene), grid, 60, grid.payload)
    np.testing.assert_array_equal(y.numpy(), model[idx.numpy()])
    np.testing.assert_array_equal(pl[:, :3].numpy(), normals.astype(np.float32)[idx.numpy()])
    assert not pl[:, 3].any()


def test_plain_nan_never_wins():
    """K4's plain version follows the kernel's ``d <= best`` fold: a NaN
    distance never wins.  A NaN model row gives what the row moved far
    away gives; a NaN scene row gets d2 = +inf, index -1 and y = 0, as the
    kernel's untouched key (+inf, no index) gives."""
    model = _sphere(1500, seed=6)
    scene = _sphere(256, seed=7) * 1.01
    scene[9, 2] = np.nan
    tgrid = tg.build_model_grid(torch.tensor(model), target_tile=128)
    nj = tgrid.tiles.shape[0]
    cand = torch.zeros((4, 1), dtype=torch.int32)
    counts = torch.full((4,), nj + 1, dtype=torch.int32)  # every tile folds all tiles
    tiles = tgrid.tiles.clone()
    victim = int(tgrid.kd_row[int(np.argmin(((model - scene[3]) ** 2).sum(1)))])
    far = tiles.clone()
    tiles.view(-1, 4)[victim, 1] = float("nan")  # scene row 3's nearest model row
    far.view(-1, 4)[victim, :3] = 1e6
    s = torch.tensor(scene)
    d2, idx, y, _ = tg.nn_grid_plain(cand, counts, s, tiles, 64, kd_row=tgrid.kd_row)
    wd2, widx, _, _ = tg.nn_grid_plain(cand, counts, s, far, 64, kd_row=tgrid.kd_row)
    assert torch.equal(idx, widx) and torch.equal(d2, wd2)
    assert int(idx[9]) == -1 and float(d2[9]) == float("inf")
    assert float(y[9].abs().sum()) == 0.0
