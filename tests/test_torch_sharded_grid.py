"""The port's sharded grid engines (``icp_tpu_torch/parallel/sharded_grid.py``)
across two gloo ranks on the CPU, against JAX's on two virtual devices.

The ranks run once for the module (``tests/torch_dist_worker.py``, suite
``grid``: K4's and K1's plain versions, every field of the model grid
riding the ring); JAX runs the same cases on ``make_mesh(jax.devices()[:2])``
with its kernels in interpret mode.  Held as ``tests/test_sharded_grid.py``
holds them: the same iterations and float64 points within atol 1e-9 (the
grid emits float32 matches in both packages), the grid within 1e-7 of the
dense ring (float64 matches there: ~1e-9 an iteration of drift), and the
plane engines' traces within rtol 1e-6.  The public ``gn_sharded_grid``
(JAX's signature, suite ``gn_grid``) is held to JAX's at one and two ranks
alike, its config's NN method ``"bcast"``: both run the grid loop whatever
it says.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import icp_tpu
from icp_tpu.engine.gicp import icp_generalized_sharded as j_gicp_sharded
from icp_tpu.engine.point_to_plane import icp_point_to_plane_sharded as j_p2pl_sharded
from icp_tpu.engine.symmetric import icp_symmetric_sharded as j_sym_sharded
from icp_tpu.parallel.mesh import make_mesh as j_make_mesh
from icp_tpu.parallel.sharded import icp_sharded as j_icp_sharded
from icp_tpu.parallel.sharded_grid import gn_sharded_grid as j_gn_sharded_grid
from tests.torch_dist_worker import (
    GN_GRID_ENGINES,
    cow_pair,
    odd_case,
    outlier_case,
    run_ranks,
    surface_case,
)

WORLD = 2
GRID = dict(nn_method="grid", grid_model_tile=128, grid_scene_tile=64)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("grid", WORLD, tmp_path_factory.mktemp("grid"))


@pytest.fixture(scope="module")
def got(ranks):
    return ranks[0]


@pytest.fixture(scope="module")
def jmesh():
    return j_make_mesh(jax.devices()[:WORLD])


def _jcfg(**kw):
    base = dict(max_iter=20, dtype=jnp.float64, solver="eigh", **GRID)
    base.update(kw)
    return icp_tpu.ICPConfig(**base)


def _same(got, want, atol, trace=False, trace_rtol=1e-9):
    res = want.result if trace else want
    assert int(got["iters"]) == int(res.iters)
    np.testing.assert_allclose(got["points"], np.asarray(res.points), rtol=0, atol=atol)
    if trace:
        it = int(res.iters)
        np.testing.assert_allclose(got["errs"][:it], np.asarray(want.errs)[:it],
                                   rtol=trace_rtol, atol=1e-20)
        assert np.all(np.isnan(got["errs"][it:]))


def test_every_rank_returns_the_same_result(ranks):
    for case, fields in ranks[0].items():
        for k, v in fields.items():
            np.testing.assert_array_equal(ranks[1][case][k], v, err_msg=f"{case}.{k}")


def test_sharded_grid_matches_jax_and_its_trace(got, jmesh):
    ref, tr1 = cow_pair()
    want = j_icp_sharded(ref, tr1, _jcfg(), mesh=jmesh, trace=True)
    _same(got["grid"], want, 1e-9, trace=True)
    np.testing.assert_allclose(float(got["grid"]["err"]), float(want.result.err), rtol=1e-9)


def test_sharded_grid_forced_overflow_matches_jax(got, jmesh):
    """A capacity of one candidate: every scene tile folds all tiles."""
    ref, tr1 = cow_pair()
    want = j_icp_sharded(ref, tr1, _jcfg(grid_max_candidates=1), mesh=jmesh)
    _same(got["overflow"], want, 1e-9)
    np.testing.assert_array_equal(got["overflow"]["points"], got["grid"]["points"])


def test_sharded_grid_matches_dense_sharded(got):
    """The pruning is invisible: the dense ring's answer."""
    assert int(got["grid"]["iters"]) == int(got["dense"]["iters"])
    np.testing.assert_allclose(got["grid"]["points"], got["dense"]["points"], rtol=0, atol=1e-7)


def test_sharded_grid_odd_unequal_counts(got, jmesh):
    """291 scene and 1,037 model rows: the global scene mask, the 1e17 model
    padding and each rank's kd padding at once."""
    model, scene = odd_case()
    want = j_icp_sharded(model, scene, _jcfg(validate_inputs=False, max_iter=40), mesh=jmesh)
    _same(got["odd"], want, 1e-9)


def test_sharded_grid_tie_breaks_to_lowest_global_index(got):
    """Every model point twice, once on each rank: the lowest global index
    wins through the pruned path."""
    np.testing.assert_array_equal(got["ties"]["gi"], np.arange(16))


def test_sharded_grid_trimmed_converges_as_jax(got, jmesh):
    """10% gross outliers, float32, trimmed at 0.2: the kept rows converge
    (JAX's bound) in JAX's iterations.  The port sums the statistics in
    float64 where JAX sums float32, so the two stop at other float32
    floors: points within 1e-5."""
    model, scene = outlier_case()
    want = j_icp_sharded(model, scene, _jcfg(dtype=jnp.float32, trim_fraction=0.2, max_iter=40,
                                             threshold=1e-8, validate_inputs=False,
                                             with_scale=False), mesh=jmesh)
    assert float(got["trimmed"]["err"]) < 1e-3
    _same(got["trimmed"], want, 1e-5)


def test_trace_bound_validation(got, jmesh):
    ref, tr1 = cow_pair()
    assert "max_iter" in str(got["bound"]["msg"])
    want = j_icp_sharded(ref[::2], tr1[::2], _jcfg(max_iter=4), mesh=jmesh, n_iters=3)
    _same(got["n_iters"], want, 1e-9)
    assert int(got["n_iters"]["iters"]) <= 3


@pytest.mark.parametrize("engine", ["p2pl", "sym", "gicp", "gicp_trimmed"])
def test_sharded_grid_plane_engines_match_jax(got, jmesh, engine):
    """``gn_sharded_grid``: the model normals ride K4's payload and the
    ring; traces within rtol 1e-6, as JAX's sharded-vs-single test."""
    model, scene = surface_case(8, 1100, 800)
    mn, sn = (jnp.asarray(got["normals"][k]) for k in ("model", "scene"))
    trace = engine != "gicp_trimmed"
    cfg = _jcfg(max_iter=25, validate_inputs=False, threshold=1e-12,
                trim_fraction=0.1 if engine == "gicp_trimmed" else 0.0)
    if engine == "p2pl":
        want = j_p2pl_sharded(model, scene, cfg, normals=mn, mesh=jmesh, trace=trace)
    elif engine == "sym":
        want = j_sym_sharded(model, scene, cfg, normals=mn, scene_normals=sn, mesh=jmesh,
                             trace=trace)
    else:
        want = j_gicp_sharded(model, scene, cfg, model_normals=mn, scene_normals=sn,
                              mesh=jmesh, trace=trace)
    _same(got[engine], want, 1e-9, trace=trace, trace_rtol=1e-6)


@pytest.fixture(scope="module", params=[1, 2], ids=["world1", "world2"])
def gn_world(request, tmp_path_factory):
    """(world size, each rank's results) of the ``gn_grid`` suite."""
    world = request.param
    return world, run_ranks("gn_grid", world, tmp_path_factory.mktemp(f"gn_grid{world}"))


@pytest.mark.parametrize("engine", GN_GRID_ENGINES)
def test_public_gn_sharded_grid_matches_jax(gn_world, engine):
    """JAX's ``gn_sharded_grid(model, scene, config, *, engine=...)`` on as
    many devices as the port's ranks, the same normals: the same
    iterations, points within 1e-9, traces within rtol 1e-6; every rank
    returns the same result."""
    world, ranks = gn_world
    got = ranks[0]
    model, scene = surface_case(8, 1100, 800)
    mn, sn = (jnp.asarray(got["normals"][k]) for k in ("model", "scene"))
    cfg = _jcfg(max_iter=25, validate_inputs=False, threshold=1e-12, nn_method="bcast")
    want = j_gn_sharded_grid(model, scene, cfg, engine=engine, model_normals=mn,
                             scene_normals=sn, mesh=j_make_mesh(jax.devices()[:world]),
                             trace=True)
    _same(got[engine], want, 1e-9, trace=True, trace_rtol=1e-6)
    for rank in ranks[1:]:
        for k, v in got[engine].items():
            np.testing.assert_array_equal(rank[engine][k], v, err_msg=f"{engine}.{k}")


def test_public_gn_sharded_grid_estimates_missing_normals(gn_world):
    """Normals left out are the port's ``estimate_normals`` of each whole
    cloud: the run equals the one given them, bit for bit."""
    got = gn_world[1][0]
    for k, v in got["estimated_given"].items():
        np.testing.assert_array_equal(got["estimated"][k], v, err_msg=k)
