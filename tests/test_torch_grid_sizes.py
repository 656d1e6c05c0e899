"""The kd-grid's sizes by device: K4's scene tile, model tile and candidate
capacity (``ICPConfig``'s ``grid_*`` fields when None), K1's seed stride,
and K7's sizes for the normals' kNN.  On CPU tensors each resolves to the
JAX package's value, so every CPU parity test keeps JAX's tiling and its
float32 sum order; a value the caller gives is used as given on either
device; and the grid's answers at the card's sizes equal those at JAX's,
on the CPU's plain versions.

The card's values are ``scripts/dispatch_sweep.py --sections grid``'s
measurements on the H100 (``perf_h100/grid_sweep.jsonl``);
``tests/test_torch_cuda.py::test_grid_sizes_on_the_card`` holds them there.
"""

import inspect
import math

import numpy as np
import pytest
import torch

import icp_tpu
from icp_tpu.engine import grid as jgrid
from icp_tpu.ops import normals as jnormals
from icp_tpu_torch import ICPConfig, config, icp
from icp_tpu_torch.engine import grid as egrid
from icp_tpu_torch.engine.icp import icp_fixed_iters
from icp_tpu_torch.engine.point_to_plane import icp_point_to_plane
from icp_tpu_torch.kernels import knn_grid, nn_grid
from icp_tpu_torch.ops.normals import knn_indices

FIELDS = ("grid_scene_tile", "grid_model_tile", "grid_max_candidates")  # also knn_indices'


def _jax_default(fn, name):
    return inspect.signature(fn).parameters[name].default


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("backend", ["cpu", torch.device("cpu")])
def test_icp_config_grid_sizes_resolve_to_jax_on_the_cpu(field, backend):
    """None on the CPU is JAX's field value; a given value stays on the CPU
    and on the card."""
    pos = FIELDS.index(field)
    assert getattr(ICPConfig(), field) is None
    assert ICPConfig().resolved_grid_sizes(backend)[pos] == getattr(icp_tpu.ICPConfig(), field)
    given = ICPConfig(**{field: 8})
    assert given.resolved_grid_sizes(backend)[pos] == 8
    assert given.resolved_grid_sizes("cuda")[pos] == 8
    assert ICPConfig().resolved_grid_sizes("cuda")[pos] == config.GRID_SIZES_CUDA[pos]


@pytest.mark.parametrize("name", FIELDS)
def test_knn_sizes_resolve_to_jax_on_the_cpu(name):
    pos = FIELDS.index(name)
    want = _jax_default(jnormals.estimate_normals, name)
    assert config.grid_sizes("cpu", knn=True)[pos] == want
    given = [None] * 3
    given[pos] = 8
    for backend in ("cpu", "cuda"):
        assert config.grid_sizes(backend, *given, knn=True)[pos] == 8
    assert config.grid_sizes("cuda", knn=True)[pos] == config.KNN_GRID_SIZES_CUDA[pos]


def test_bound_stride_resolves_to_jax_on_the_cpu():
    assert egrid.bound_stride_for(torch.device("cpu")) \
        == _jax_default(jgrid._icp_grid, "bound_stride")
    assert egrid.bound_stride_for(torch.device("cuda")) == egrid.BOUND_STRIDE_CUDA


@pytest.fixture
def seen(monkeypatch):
    """The sizes each grid build, scene sort, NN or kNN table and seed was
    given, wherever the engines import them from."""
    got = {}

    def spy(module, name, record):
        real = getattr(module, name)

        def wrapped(*a, **k):
            for key, v in record(*a, **k).items():
                got.setdefault(key, set()).add(v)
            return real(*a, **k)
        monkeypatch.setattr(module, name, wrapped)

    for mod in (nn_grid, egrid):
        spy(mod, "build_model_grid", lambda m, *, target_tile=1024, payload=None:
            {"model_tile": target_tile})
        spy(mod, "closest_point_indices_grid", lambda *a, max_candidates=16, **k:
            {"max_candidates": max_candidates})
    spy(egrid, "initial_bound_indices", lambda s, m, *, stride=16: {"stride": stride})
    spy(egrid, "_prepare_scene", lambda s, target_tile, n_valid=None:
        {"scene_tile": target_tile})
    spy(knn_grid, "knn_grid", lambda *a, max_candidates=16, **k:
        {"max_candidates": max_candidates})
    return got


def _pair(n=600, seed=3):
    r = np.random.default_rng(seed)
    model = r.standard_normal((n, 3)).astype(np.float32)
    scene = (1.02 * model + 0.01 * r.standard_normal((n, 3)) + 0.02).astype(np.float32)
    return torch.tensor(model), torch.tensor(scene)


GIVEN = dict(grid_scene_tile=64, grid_model_tile=128, grid_max_candidates=4)
GIVEN_SEEN = {"scene_tile": {64}, "model_tile": {128}, "max_candidates": {4}}


def _run(entry: str, given: bool):
    model, scene = _pair()
    kw = GIVEN if given else {}
    if entry == "icp":
        icp(model, scene, ICPConfig(nn_method="grid", max_iter=2, **kw), device="cpu")
    elif entry == "icp_fixed_iters":
        icp_fixed_iters(model, scene, n_iters=2, nn_method="grid")
    elif entry == "_icp_grid":
        egrid._icp_grid(model, scene, threshold=-math.inf, bound=2, length=2, solver="eigh",
                        with_scale=True, reference_compat=True, scene_tile_target=64,
                        model_tile_target=128, max_candidates=4, bound_stride=8)
    elif entry == "point_to_plane":
        icp_point_to_plane(model, scene, ICPConfig(nn_method="grid", max_iter=2, **kw),
                           normals=torch.nn.functional.normalize(model, dim=1), device="cpu")
    else:
        knn_indices(model, 5, method="grid", **({k: v // 2 for k, v in GIVEN.items()}
                                                 if given else {}))


@pytest.mark.parametrize("entry,given,want", [
    ("icp", False, {"scene_tile": {256}, "model_tile": {1024}, "max_candidates": {16},
                    "stride": {16}}),
    ("icp", True, dict(GIVEN_SEEN, stride={16})),
    ("icp_fixed_iters", False, {"scene_tile": {256}, "model_tile": {1024},
                                "max_candidates": {16}, "stride": {16}}),
    ("_icp_grid", True, dict(GIVEN_SEEN, stride={8})),
    ("point_to_plane", False, {"scene_tile": {256}, "model_tile": {1024},
                               "max_candidates": {16}, "stride": {16}}),
    ("point_to_plane", True, dict(GIVEN_SEEN, stride={16})),
    ("knn_indices", False, {"scene_tile": {64}, "model_tile": {256}, "max_candidates": {32}}),
    ("knn_indices", True, {"scene_tile": {32}, "model_tile": {64}, "max_candidates": {2}}),
])
def test_engines_take_jax_sizes_on_cpu_tensors_and_given_sizes_as_given(
        seen, entry, given, want):
    """JAX's sizes reach the grid's builds, tables and seed on CPU tensors
    when the caller gives none (``_icp_grid``'s defaults are JAX's:
    ``icp_tpu/engine/grid.py:174-178``); a caller's sizes reach them as
    given."""
    _run(entry, given)
    assert seen == want


def _similar_pair(n=6000, seed=11):
    """A seeded 6,000-point surface and a scene moved off it by a small
    similarity, with noise."""
    r = np.random.default_rng(seed)
    u, v = r.uniform(-1, 1, (2, n))
    model = np.stack([u, v, 0.3 * np.sin(2 * u) * np.cos(3 * v)], 1)
    axis = r.standard_normal(3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    rot = np.eye(3) + np.sin(0.05) * K + (1 - np.cos(0.05)) * K @ K
    scene = 1.02 * (model + 0.002 * r.standard_normal(model.shape)) @ rot.T + 0.01
    return torch.tensor(model, dtype=torch.float32), torch.tensor(scene, dtype=torch.float32)


def test_grid_answers_at_the_cards_sizes_equal_jaxs_on_the_cpu(monkeypatch):
    """``nn_method="grid"`` at JAX's sizes and at the card's (tiles,
    capacity, seed stride), on the plain versions: the first iteration's
    indices bit-equal (exact folds, lowest-index ties, whatever the
    tiling), then 4 iterations with the same count and points within 1e-6
    (the kd order of the scene changes with its tile, so the float64 sums
    add in another order)."""
    model, scene = _similar_pair()
    calls = []
    real = egrid.closest_point_indices_grid
    monkeypatch.setattr(egrid, "closest_point_indices_grid",
                        lambda *a, **k: calls.append(real(*a, **k)) or calls[-1])
    names = ("scene_tile_target", "model_tile_target", "max_candidates")
    runs = []
    for sizes, stride in ((config.GRID_SIZES, egrid.BOUND_STRIDE),
                          (config.GRID_SIZES_CUDA, egrid.BOUND_STRIDE_CUDA)):
        start = len(calls)
        res = egrid._icp_grid(model, scene, threshold=-math.inf, bound=4, length=4,
                              solver="qcp_fused", with_scale=True, reference_compat=True,
                              converge=False, bound_stride=stride, **dict(zip(names, sizes)))
        inv = egrid._prepare_scene(scene, sizes[0])[2]
        runs.append((calls[start][0][inv], res))
    (i0, r0), (i1, r1) = runs
    orig = (i0, i1)
    assert torch.equal(orig[0], orig[1])
    assert int(r0.iters) == int(r1.iters) == 4
    assert float((r0.points - r1.points).abs().max()) <= 1e-6


def test_knn_at_the_cards_sizes_equals_jaxs_on_the_cpu():
    """K7's plain version at JAX's sizes and at the card's: the same
    neighbours (exact, lowest-index ties)."""
    pts = _similar_pair(n=4000, seed=5)[0]
    want = knn_indices(pts, 17, method="grid")
    got = knn_indices(pts, 17, method="grid", **dict(zip(FIELDS, config.KNN_GRID_SIZES_CUDA)))
    assert torch.equal(got, want)
