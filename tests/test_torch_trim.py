"""Trimmed ICP in the port against the JAX package (``tests/test_trimmed.py``).

  * ``histogram_quantile``: tau bit-equal to JAX's for the same values and
    mask, in float32 and float64, and the bracket property (at least q of
    the rows kept; tau within range/32^2 above the order statistic); no
    host read in the quantile and the trim weights; K4's plain distances
    bit-equal to the dense trim's.
  * ``icp`` with ``trim_fraction`` on an outlier-corrupted problem in
    float64: the plain path (``bcast``/``eigh``), the pipeline
    (``pallas``/``qcp_fused``: K1, the weighted float64 sums, K2) and the
    grid path (K4's distances, K2), against JAX's ``eigh`` run on the same
    NN method family: the same iterations, the trace within rtol 1e-5 and
    atol 1e-12 (K2's closed-form residual gy + s^2 gp - 2 s lambda cancels
    to ~1e-15 at convergence, where JAX's explicit residual gives another
    ~1e-15), points within atol 1e-6.
  * The three plane engines trimmed, dense and grid, float64, the same
    normals from JAX: the same iterations, points within atol 1e-8.
  * The CLI with ``--trim 0.1`` on the cow pairs against the JAX CLI's
    fixtures (``tests/fixtures/torch_trim/``): the same iterations, the
    trace within rtol 1e-2 on entries > 1e-6 (``chip_smoke.TRACE_RTOL``),
    the cloud within atol 1e-5.  Point-to-point runs the card's path
    (``--nn pallas --solver qcp_fused``) against the float64 fixture.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_tpu
from icp_tpu.ops.normals import estimate_normals as j_normals
from icp_tpu.ops.quantile import histogram_quantile as j_quantile
from icp_tpu_torch import ICPConfig, icp
from icp_tpu_torch.engine.plane import run_engine
from icp_tpu_torch.ops.quantile import histogram_quantile
from tests.test_torch_point_to_plane import check_cli_against_fixtures
from tests.test_trimmed import _make_outlier_problem

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "torch_trim")
GRID = dict(grid_scene_tile=64, grid_model_tile=128)


def _values(seed, n, dtype):
    """Gamma-distributed squared distances over six decades, a fifth of them
    rounded to quarters (ties and values on the bin edges)."""
    rng = np.random.default_rng(seed)
    d2 = rng.gamma(2.0, 1.0, n) * 10.0 ** rng.uniform(-6, 2)
    if seed % 5 == 0:
        d2 = np.round(d2 * 4) / 4
    return d2.astype(dtype), (rng.random(n) > 0.3).astype(dtype)


@pytest.mark.parametrize("masked", [False, True], ids=["all_rows", "masked"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float32", "float64"])
def test_histogram_quantile_bit_equal_to_jax(dtype, masked):
    for seed in range(12):  # three shapes: JAX compiles once for each
        d2, w = _values(seed, (50, 1000, 4099)[seed % 3], dtype)
        for q in (0.5, 0.7, 0.9, 0.999):
            want = np.asarray(j_quantile(jnp.asarray(d2), q,
                                         jnp.asarray(w) if masked else None))
            got = histogram_quantile(torch.tensor(d2), q,
                                     torch.tensor(w) if masked else None).numpy()
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), (seed, q)


def test_histogram_quantile_brackets_exact():
    rng = np.random.default_rng(0)
    d2 = torch.tensor(rng.gamma(2.0, 1.0, 4096))
    width = float(d2.max())
    for q in (0.5, 0.7, 0.9, 0.999):
        tau = float(histogram_quantile(d2, q))
        assert float((d2 <= tau).double().mean()) >= q  # never trims more than asked
        k = int(np.ceil(q * d2.shape[0]))
        x_k = float(torch.sort(d2).values[k - 1])
        assert x_k <= tau * (1 + 1e-12)
        assert tau - x_k <= width / 32 ** 2 * (1 + 1e-6), (q, tau, x_k)


def test_histogram_quantile_mask_excludes_rows():
    rng = np.random.default_rng(1)
    d2 = torch.tensor(rng.gamma(2.0, 1.0, 1000))
    w = torch.ones(1000, dtype=torch.float64)
    w[::3] = 0.0
    poisoned = d2.clone()
    poisoned[::3] = 1e30  # masked rows must not move tau at all
    assert float(histogram_quantile(d2, 0.8, w)) == float(histogram_quantile(poisoned, 0.8, w))


def test_trim_reads_nothing_to_the_host():
    """The quantile and the trim weights of both paths queue device work
    only: no value read to the host (``_local_scalar_dense``, the op behind
    ``.item()`` and a 0-d tensor index) and no tensor made from host data
    (``lift_fresh``, a copy to the card there), so a trimmed loop keeps one
    read of the done flag a chunk."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from icp_tpu_torch.engine.grid import grid_weights
    from icp_tpu_torch.engine.icp import trim_weights

    class HostReads(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ in ("_local_scalar_dense", "lift_fresh"):
                self.seen.append(func)
            return func(*args, **(kwargs or {}))

    rng = np.random.default_rng(2)
    p, y = (torch.tensor(rng.standard_normal((500, 3)), dtype=torch.float32) for _ in range(2))
    mask = (torch.arange(500) < 450).to(torch.float32)
    d2 = ((y - p) ** 2).sum(1)
    with HostReads() as reads:
        histogram_quantile(d2, 0.9)
        trim_weights(p, y, 0.1, mask)
        grid_weights(p, y, d2, mask, 0.1)
        grid_weights(p.double(), y.double(), d2, mask.double(), 0.1)
    assert reads.seen == []


def test_k4_plain_distances_are_the_dense_trims():
    """The grid trim reads K4's float32 distances: its plain version's d2 is
    bit for bit the dense trim's ``sqnorm_rows(y - p)`` of its matches, so
    both paths keep the same rows (``chip_smoke.py`` holds the kernel's d2
    bit-equal to this plain version)."""
    from icp_tpu_torch.engine.grid import _prepare_scene
    from icp_tpu_torch.kernels.nn_grid import (
        bound_from_indices,
        build_model_grid,
        closest_point_indices_grid,
        initial_bound_indices,
        sqnorm_rows,
    )

    rng = np.random.default_rng(4)
    model = torch.tensor(rng.standard_normal((1500, 3)), dtype=torch.float32)
    scene = torch.tensor(rng.standard_normal((1100, 3)), dtype=torch.float32)
    grid = build_model_grid(model, target_tile=128)
    p, _, _, tn, _ = _prepare_scene(scene, 64)
    u = bound_from_indices(p, grid, initial_bound_indices(p, grid.model_orig, stride=4))
    _, y, _, d2 = closest_point_indices_grid(p, grid, u, scene_tile=tn)
    assert torch.equal(d2, sqnorm_rows(y - p))


# (port NN, port solver, JAX NN): JAX's reference is its float64 eigh run
PATHS = [("bcast", "eigh", "bcast"), ("pallas", "qcp_fused", "bcast"),
         ("grid", "qcp_fused", "grid")]


@pytest.mark.parametrize("nn,solver,jnn", PATHS, ids=[p[0] for p in PATHS])
def test_trimmed_icp_matches_jax_float64(nn, solver, jnn):
    world, scene, R, _ = _make_outlier_problem(np.random.default_rng(11))
    base = dict(max_iter=60, with_scale=False, validate_inputs=False, trim_fraction=0.3,
                **GRID)
    jtr = icp_tpu.icp(world, scene, icp_tpu.ICPConfig(dtype=jnp.float64, solver="eigh",
                                                      nn_method=jnn, **base), trace=True)
    tr = icp(world, scene, ICPConfig(dtype=torch.float64, solver=solver, nn_method=nn, **base),
             trace=True, device="cpu")
    n = int(tr.result.iters)
    assert n == int(jtr.result.iters) and n >= 3
    np.testing.assert_allclose(tr.errs[:n].numpy(), np.asarray(jtr.errs)[:n], rtol=1e-5,
                               atol=1e-12)
    np.testing.assert_allclose(tr.result.points.numpy(), np.asarray(jtr.result.points),
                               atol=1e-6)
    # the outliers are rejected: the inverse rotation is recovered
    assert np.abs(tr.result.transform.R.numpy() @ R - np.eye(3)).max() < 1e-4


def test_trim_zero_is_the_untrimmed_path():
    world, scene, _, _ = _make_outlier_problem(np.random.default_rng(3), n=200, n_out=20)
    base = dict(max_iter=10, dtype=torch.float64, validate_inputs=False)
    a = icp(world, scene, ICPConfig(**base), trace=True, device="cpu")
    b = icp(world, scene, ICPConfig(trim_fraction=0.0, **base), trace=True, device="cpu")
    assert torch.equal(torch.nan_to_num(a.errs, nan=-1.0), torch.nan_to_num(b.errs, nan=-1.0))
    assert torch.equal(a.result.points, b.result.points)


def _surface_pair(n_model=420, n_scene=333, angle=0.12, seed=5):
    """The smooth surface of ``tests/test_padding.py`` with 10% of the scene
    rows pushed 0.3 off it."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(-1.0, 1.0, size=(n_model, 2))
    model = np.column_stack([g, 0.3 * np.sin(2.0 * g[:, 0]) + 0.2 * np.cos(3.0 * g[:, 1])])
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    scene = model[:n_scene] @ R.T + np.array([0.03, -0.01, 0.02])
    scene[::10] += 0.3 * rng.standard_normal((len(scene[::10]), 3))
    return model, scene


@pytest.mark.parametrize("nn", ["bcast", "grid"])
@pytest.mark.parametrize("engine", ["point_to_plane", "symmetric", "gicp"])
def test_plane_engines_trimmed_match_jax(engine, nn):
    from icp_tpu.engine.gicp import icp_generalized as j_gicp
    from icp_tpu.engine.point_to_plane import icp_point_to_plane as j_p2pl
    from icp_tpu.engine.symmetric import icp_symmetric as j_sym

    model, scene = _surface_pair()
    nm = np.asarray(j_normals(jnp.asarray(model), k=12))
    ns = np.asarray(j_normals(jnp.asarray(scene), k=12))
    base = dict(max_iter=25, nn_method=nn, validate_inputs=False, threshold=1e-12,
                trim_fraction=0.2, **GRID)
    jcfg = icp_tpu.ICPConfig(dtype=jnp.float64, **base)
    if engine == "point_to_plane":
        jres = j_p2pl(model, scene, jcfg, normals=nm)
    elif engine == "symmetric":
        jres = j_sym(model, scene, jcfg, normals=nm, scene_normals=ns)
    else:
        jres = j_gicp(model, scene, jcfg, model_normals=nm, scene_normals=ns)
    res = run_engine(engine, model, scene, ICPConfig(dtype=torch.float64, **base),
                     model_normals=nm, scene_normals=ns, device="cpu")
    assert int(res.iters) == int(jres.iters) >= 2
    np.testing.assert_allclose(res.points.numpy(), np.asarray(jres.points), atol=1e-8)
    np.testing.assert_allclose(float(res.err), float(jres.err), rtol=1e-6, atol=1e-18)


# (engine, pair, iterations, extra flags)
CLI = [("point_to_point", "cow_tr1", 8, ["--nn", "pallas", "--solver", "qcp_fused"]),
       ("point_to_point", "cow_tr2", 17, ["--nn", "pallas", "--solver", "qcp_fused"]),
       ("point_to_plane", "cow_tr1", 4, []), ("symmetric", "cow_tr2", 7, []),
       ("gicp", "cow_tr1", 3, [])]


@pytest.mark.parametrize("engine,name,iters,extra", CLI, ids=[f"{e}-{n}" for e, n, _, _ in CLI])
def test_cli_trim_matches_jax_fixtures(tmp_path, engine, name, iters, extra):
    check_cli_against_fixtures(tmp_path, engine, FIXDIR, name, iters,
                               extra=["--trim", "0.1", *extra], prefix=f"{engine}_")
