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


@pytest.mark.parametrize("k", [1, 5, 17, 32, 33, 64])
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
    with pytest.raises(ValueError, match="outside 1..128"):
        tkd.knn_dense(torch.tensor(_cloud(4, 140)), torch.tensor(_cloud(5, 140)), 129)


def test_knn_cap_of_128_where_jax_has_none():
    """JAX's kNN takes any k <= len(points); the port's kernels keep at most
    128 in registers, and both wrappers refuse more with a ValueError naming
    the cap (on the CPU too: no fall back to the plain version)."""
    q, p = _cloud(6, 40), _cloud(7, 200)
    _, ji = knn_pallas(jnp.asarray(q), jnp.asarray(p), 129, query_tile=32, point_tile=128)
    assert np.asarray(ji).shape == (40, 129)
    with pytest.raises(ValueError, match="at most 128"):
        tkd.knn_dense(torch.tensor(q), torch.tensor(p), 129)
    grid = tg.build_model_grid(torch.tensor(p), target_tile=128)
    with pytest.raises(ValueError, match="at most 128"):
        tkg.knn_grid(torch.tensor(q), grid, 129)
    d2, idx = tkd.knn_dense(torch.tensor(q), torch.tensor(p), 128)  # the cap itself runs
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji)[:, :128])


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


def _same_up_to_near_ties(idx, d2, ji, jd, ulps=4):
    """Indices equal to JAX's except at ranks where JAX's contracted
    distances make two neighbours tie within ``ulps`` and its lowest index
    wins: there the port's index is one that JAX ranks within ``ulps`` of
    that rank's distance (or at the list's end, past it)."""
    _within_ulps(d2, jd, ulps)
    idx, ji, jd = np.asarray(idx), np.asarray(ji), np.asarray(jd, np.float32)
    for r, c in np.argwhere(idx != ji):
        tol = ulps * np.spacing(jd[r, c])
        near = np.abs(jd[r] - jd[r, c]) <= tol
        assert idx[r, c] in ji[r][near] or (near[-1] and idx[r, c] not in ji[r]), (r, c)


@pytest.mark.parametrize("k,max_candidates", [(33, 16), (64, 16), (64, 1)])
def test_knn_grid_long_lists_match_jax_and_dense(k, max_candidates):
    """k above 32, the lists of two slots a lane (FPFH fetches 64): equal
    to the port's dense kNN bit for bit, and to JAX's up to its near ties
    (at k = 64 XLA's contracted distances tie neighbours 1-2 ulp apart)."""
    pts, query, jgrid, tgrid = _grid_case(10 + k)
    jd, ji = jkg.knn_grid(jnp.asarray(query), jgrid, k, scene_tile=64,
                          max_candidates=max_candidates)
    d2, idx = tkg.knn_grid(torch.tensor(query), tgrid, k, scene_tile=64,
                           max_candidates=max_candidates)
    assert idx.shape == (query.shape[0], k)
    _same_up_to_near_ties(idx.numpy(), d2.numpy(), ji, jd)
    dd, di = tkd.knn_dense(torch.tensor(query), torch.tensor(pts), k)
    assert torch.equal(idx, di) and torch.equal(d2, dd)


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


def _exact_table(pts, query, k, cap, tn=64):
    """The exact pass's table and bound as ``knn_grid`` builds them, on the
    port's own grid of ``pts``."""
    grid = tg.build_model_grid(torch.tensor(pts), target_tile=128)
    q = torch.tensor(query)
    bd2 = tg.tile_box_dists(q, grid, scene_tile=tn)
    d_seed, _ = tkg.knn_worklist(*tkg.seed_table(bd2, k, grid.model_tile), q, grid.tiles, tn, k)
    kth = d_seed[:, k - 1].contiguous()
    cand, counts = tkg.cull_table(bd2, kth, tn, min(cap, bd2.shape[1]))
    return grid, q, cand, counts, kth


@pytest.mark.parametrize("k,max_candidates", [(8, 16), (17, 16), (5, 1)])
def test_knn_worklist_plain_bound_changes_nothing_and_matches_jax(k, max_candidates):
    """The exact pass with the seed's k-th distance as each point's bound
    equals it without, and JAX's knn_grid (interpret mode)."""
    pts, query, jgrid, _ = _grid_case(60 + k, n_query=640)
    grid, q, cand, counts, kth = _exact_table(pts, query, k, max_candidates)
    if max_candidates == 1:
        assert (counts > 1).any()  # tiles that fold every tile
    args = (cand, counts, q, grid.tiles, 64, k)
    with_bound = tkg.knn_worklist_plain(*args, bound=kth)
    without = tkg.knn_worklist_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(with_bound, without))
    assert all(torch.equal(a, b) for a, b in zip(tkg.knn_worklist(*args, bound=kth), with_bound))
    jd, ji = jkg.knn_grid(jnp.asarray(query), jgrid, k, scene_tile=64,
                          max_candidates=max_candidates)
    np.testing.assert_array_equal(with_bound[1].numpy(), np.asarray(ji))
    _within_ulps(with_bound[0].numpy(), jd)


def test_knn_worklist_plain_rows_beyond_the_bound_are_no_candidates():
    """A bound below a query's k-th distance leaves places that no row
    within it fills: +inf and index -1, as the kernel writes them."""
    pts, query, _, _ = _grid_case(70, n_query=128)
    grid, q, cand, counts, kth = _exact_table(pts, query, 6, 16)
    d_full, i_full = tkg.knn_worklist_plain(cand, counts, q, grid.tiles, 64, 6)
    tight = d_full[:, 2].contiguous()  # only the three nearest are within it
    d2, idx = tkg.knn_worklist_plain(cand, counts, q, grid.tiles, 64, 6, bound=tight)
    within = d_full <= tight[:, None]
    assert torch.equal(idx[within], i_full[within]) and torch.equal(d2[within], d_full[within])
    assert (idx[~within] == -1).all() and torch.isinf(d2[~within]).all()
    assert within[:, :3].all()
    with pytest.raises(ValueError, match="bound"):
        tkg.knn_worklist_plain(cand, counts, q, grid.tiles, 64, 6, bound=tight[:-1])


def _decode_k7_item(cand, counts, first, nj, item):
    """(query tile, its model tiles) of K7's work item ``item``, as the fold
    kernel decodes it: the last tile whose first item is <= item, then
    ``per`` consecutive tiles of its fold list from ``(item - first) * per``."""
    ti = int(torch.searchsorted(first[:-1], torch.tensor(item, dtype=first.dtype),
                                right=True)) - 1
    g, gf = tkg.item_tiles(nj)
    cnt = int(counts[ti])
    per = gf if cnt > cand.shape[1] else g
    fold = tg.tile_ids(cand, nj, ti, cnt).tolist()
    c = item - int(first[ti])
    return ti, fold[c * per:(c + 1) * per]


@pytest.mark.parametrize("cap,max_split", [(16, 64), (3, 64), (1, 64), (1, 3)])
def test_work_items_cover_each_fold_list(monkeypatch, cap, max_split):
    """K7's plan on JAX's own exact-pass table: each query tile's items,
    decoded as the kernel decodes them, are its fold list once, in order;
    the tiles of more than one item get one scratch slot per item, and the
    others none.  ``max_split`` 3 cuts a list of all tiles into longer
    items than a candidate list's."""
    monkeypatch.setattr(tkg, "MAX_SPLIT", max_split)
    pts, query, jgrid, tgrid = _grid_case(80, n_query=640)
    query = query[np.argsort(query[:, 0], kind="stable")]  # slabs: counts 5-11
    q8 = jnp.zeros((640, 8), jnp.float32).at[:, :3].set(jnp.asarray(query))
    bd2 = np.asarray(jg.tile_box_dists(q8, jgrid, scene_tile=64))
    u = torch.tensor(np.repeat(np.geomspace(1e-3, 1.0, 10), 64), dtype=torch.float32)
    cand, counts = tkg.cull_table(torch.tensor(bd2), u, 64, cap)
    counts[::3] = torch.tensor([0, 2, 4, 1], dtype=torch.int32)  # tiles of one item
    nj = tgrid.tiles.shape[0]
    first, slots = tkg.knn_work_items(counts, cap, nj)
    assert first.dtype == slots.dtype == torch.int32
    assert first.shape == slots.shape == (counts.shape[0] + 1,)
    folds = [tg.tile_ids(cand, nj, ti, c).tolist() for ti, c in enumerate(counts.tolist())]
    got = [[] for _ in folds]
    for item in range(int(first[-1])):
        ti, tiles = _decode_k7_item(cand, counts, first, nj, item)
        assert tiles
        got[ti].extend(tiles)
    assert got == folds
    n_items = (first[1:] - first[:-1]).tolist()
    n_slots = (slots[1:] - slots[:-1]).tolist()
    assert n_slots == [n if n > 1 else 0 for n in n_items]
    assert 1 in n_items and max(n_items) > 1
    if cap == 1:
        over = counts > cap
        assert over.any()
        g, gf = tkg.item_tiles(nj)
        assert gf == (max(g, -(-nj // max_split)))
        assert {n_items[t] for t in torch.nonzero(over).flatten().tolist()} == {-(-nj // gf)}
