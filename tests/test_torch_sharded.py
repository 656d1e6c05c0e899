"""The port's sharded engines (``icp_tpu_torch/parallel/sharded.py``) across
four gloo ranks on the CPU, against JAX's on four virtual devices.

The ranks run once for the module (``tests/torch_dist_worker.py``, suite
``sharded``), each on the same full inputs; JAX runs the same cases on
``make_mesh(jax.devices()[:4])`` and a 2 x 2 ``make_mesh_2d``.  Held, as
``tests/test_sharded.py`` holds sharded against single-device JAX: the
same iteration count, float64 points within atol 1e-9 (1e-8 for the odd
counts, whose 40 iterations never converge), the same lowest-global-index
tie-breaks.  Every rank returns the same result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import icp_tpu
from icp_tpu.engine.gicp import icp_generalized_sharded as j_gicp_sharded
from icp_tpu.engine.point_to_plane import icp_point_to_plane_sharded as j_p2pl_sharded
from icp_tpu.engine.symmetric import icp_symmetric_sharded as j_sym_sharded
from icp_tpu.ops.quantile import histogram_quantile as j_histogram_quantile
from icp_tpu.parallel.mesh import make_mesh as j_make_mesh
from icp_tpu.parallel.sharded import icp_sharded as j_icp_sharded
from icp_tpu.parallel.sharded import icp_sharded_2d as j_icp_sharded_2d
from icp_tpu.parallel.sharded import make_mesh_2d as j_make_mesh_2d
from tests import oracle
from tests.torch_dist_worker import cow_pair, odd_case, quantile_case, run_ranks, surface_case

WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("sharded", WORLD, tmp_path_factory.mktemp("sharded"))


@pytest.fixture(scope="module")
def got(ranks):
    return ranks[0]


@pytest.fixture(scope="module")
def jmesh():
    return j_make_mesh(jax.devices()[:WORLD])


def _jcfg(**kw):
    base = dict(max_iter=20, dtype=jnp.float64, solver="eigh", nn_method="bcast")
    base.update(kw)
    return icp_tpu.ICPConfig(**base)


def _same(got, want, atol, trace=False):
    res = want.result if trace else want
    assert int(got["iters"]) == int(res.iters)
    np.testing.assert_allclose(got["points"], np.asarray(res.points), rtol=0, atol=atol)
    np.testing.assert_allclose(float(got["err"]), float(res.err), rtol=1e-9, atol=1e-20)
    if trace:
        it = int(res.iters)
        np.testing.assert_allclose(got["errs"][:it], np.asarray(want.errs)[:it], rtol=1e-9,
                                   atol=1e-20)
        assert np.all(np.isnan(got["errs"][it:]))


def test_every_rank_returns_the_same_result(ranks):
    for other in ranks[1:]:
        assert other.keys() == ranks[0].keys()
        for case, fields in ranks[0].items():
            for k, v in fields.items():
                np.testing.assert_array_equal(other[case][k], v, err_msg=f"{case}.{k}")


@pytest.mark.parametrize("case,kw", [("ring", dict(ring=True)), ("allgather", dict(ring=False)),
                                     ("pallas", dict(nn_method="pallas"))])
def test_sharded_matches_jax(got, jmesh, case, kw):
    """The ring, the all-gather and K1's hop (JAX's K1 in interpret mode,
    the port's plain K1) on cow / 10."""
    ref, tr1 = cow_pair()
    ring = kw.pop("ring", True)
    want = j_icp_sharded(ref, tr1, _jcfg(**kw), mesh=jmesh, ring=ring)
    _same(got[case], want, 1e-9)


def test_sharded_odd_counts_padding(got, jmesh):
    model, scene = odd_case()
    want = j_icp_sharded(model, scene, _jcfg(validate_inputs=False, max_iter=40), mesh=jmesh)
    _same(got["odd"], want, 1e-8)


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_ring_correspondence_global_indices(got, impl):
    rng = np.random.default_rng(1)
    p, m = rng.standard_normal((64, 3)), rng.standard_normal((160, 3))
    want = oracle.closest_indices(p, m)
    np.testing.assert_array_equal(got[f"indices_{impl}"]["gi"], want)
    np.testing.assert_allclose(got[f"indices_{impl}"]["pt"], m[want], rtol=1e-12)


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_ring_tie_breaks_to_lowest_global_index(got, impl):
    """Every model point equal: each scene point matches global index 0,
    whichever shard the ring visits first."""
    np.testing.assert_array_equal(got[f"ties_{impl}"]["gi"], np.zeros(16, np.int32))


def test_sharded_trace_matches_jax_trace(got, jmesh):
    ref, tr1 = cow_pair()
    _same(got["ring"], j_icp_sharded(ref, tr1, _jcfg(), mesh=jmesh, trace=True), 1e-9,
          trace=True)
    _same(got["pallas"], j_icp_sharded(ref, tr1, _jcfg(nn_method="pallas"), mesh=jmesh,
                                       trace=True), 1e-9, trace=True)


def test_2d_mesh_matches_jax_and_its_trace(got):
    ref, tr1 = cow_pair()
    want = j_icp_sharded_2d(ref, tr1, _jcfg(), mesh=j_make_mesh_2d(2, 2), trace=True)
    _same(got["mesh2d"], want, 1e-9, trace=True)


def test_2d_mesh_odd_counts(got):
    model, scene = odd_case(4, 1.2)
    want = j_icp_sharded_2d(model, scene, _jcfg(validate_inputs=False, max_iter=40),
                            mesh=j_make_mesh_2d(2, 2))
    _same(got["mesh2d_odd"], want, 1e-8)


@pytest.mark.parametrize("case", ["trimmed", "mesh2d_trimmed"])
def test_trimmed_sharded_matches_jax(got, jmesh, case):
    """The distributed quantile in the loop, on the 1-D and the 2-D mesh."""
    ref, tr1 = cow_pair()
    if case == "trimmed":
        want = j_icp_sharded(ref, tr1, _jcfg(trim_fraction=0.1), mesh=jmesh)
    else:
        want = j_icp_sharded_2d(ref, tr1, _jcfg(trim_fraction=0.1), mesh=j_make_mesh_2d(2, 2))
    _same(got[case], want, 1e-9)


def test_distributed_quantile_is_the_single_device_one(got):
    """Four shards of the values give the threshold of all of them, and it
    is JAX's."""
    d2, w = quantile_case()
    q = got["quantile"]
    assert float(q["sharded"]) == float(q["single"])
    assert float(q["single"]) == float(j_histogram_quantile(jnp.asarray(d2), 0.7,
                                                            jnp.asarray(w)))


def test_n_iters_bound_and_trace_bound(got, jmesh):
    ref, tr1 = cow_pair()
    want = j_icp_sharded(ref, tr1, _jcfg(max_iter=4), mesh=jmesh, n_iters=3)
    _same(got["n_iters"], want, 1e-9)
    assert int(got["n_iters"]["iters"]) == 3
    assert "max_iter" in str(got["bound"]["msg"])


@pytest.mark.parametrize("engine", ["p2pl", "p2pl_trimmed", "sym", "gicp"])
def test_sharded_plane_engines_match_jax(got, jmesh, engine):
    """The dense ring of the plane engines (normals, or GICP's covariances,
    riding the ring) on the same normals."""
    model, scene = surface_case(6, 500, 400)
    mn, sn = (jnp.asarray(got["normals"][k]) for k in ("model", "scene"))
    cfg = _jcfg(max_iter=25, validate_inputs=False, threshold=1e-12,
                trim_fraction=0.1 if engine == "p2pl_trimmed" else 0.0)
    if engine.startswith("p2pl"):
        want = j_p2pl_sharded(model, scene, cfg, normals=mn, mesh=jmesh)
    elif engine == "sym":
        want = j_sym_sharded(model, scene, cfg, normals=mn, scene_normals=sn, mesh=jmesh)
    else:
        want = j_gicp_sharded(model, scene, cfg, model_normals=mn, scene_normals=sn,
                              mesh=jmesh)
    _same(got[engine], want, 1e-9)
