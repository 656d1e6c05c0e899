"""Three faults of the port against JAX, held on the CPU.

  * Fixed mode runs every iteration: ``icp_fixed_iters`` with a NaN
    coordinate runs ``n_iters`` on every path, as JAX's ``fori_loop`` does
    (the convergence test ``not err >= threshold`` is true for NaN and used
    to stop it after one iteration).
  * A non-finite Horn matrix gives a NaN result, not an exception: ``icp``
    with a NaN coordinate takes one iteration and reports a NaN error under
    ``eigh``, ``qcp`` and ``kabsch``, as JAX does, and ``guard=True`` raises
    ``FloatingPointError`` (``torch.linalg.eigh``/``svd`` used to raise).
  * Full float32 whatever the caller set: inside every public entry point
    the float32 matmul precision reads ``"highest"``, and the caller's
    ``"high"`` (TF32 on the card) is back afterwards, also after an
    exception.

The inputs are seeded numpy arrays handed to both packages.
"""

import contextlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import icp_tpu
import icp_tpu_torch
from icp_tpu.engine.grid import _icp_grid as jax_icp_grid
from icp_tpu.engine.icp import icp_fixed_iters as jax_icp_fixed_iters
from icp_tpu_torch.engine.cli import main as cli_main
from icp_tpu_torch.ops.normals import knn_indices


def _pair(n=300, seed=0, nan=True):
    """(model, scene) float32: a seeded Gaussian cloud and its image under a
    small similarity, with one NaN coordinate in the scene."""
    rng = np.random.default_rng(seed)
    model = rng.standard_normal((n, 3)).astype(np.float32)
    a = 0.1
    R = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]])
    scene = (1.02 * model @ R.T + 0.05).astype(np.float32)
    if nan:
        scene[5, 1] = np.nan
    return model, scene


# every path of icp_fixed_iters: the plain solvers with the broadcast NN
# and K1, the fused K3 path (its last block solves), and the grid path (K1
# seed, K4, K2 or a plain solver)
FIXED_PATHS = [("eigh", "bcast"), ("qcp", "bcast"), ("kabsch", "bcast"), ("eigh", "pallas"),
               ("qcp", "pallas"), ("kabsch", "pallas"), ("qcp_fused", "pallas"),
               ("eigh", "grid"), ("qcp_fused", "grid")]


@pytest.mark.parametrize("solver,nn", FIXED_PATHS)
def test_torch_fixed_iters_nan(solver, nn):
    model, scene = _pair()
    got = icp_tpu_torch.icp_fixed_iters(model, scene, n_iters=10, solver=solver, nn_method=nn,
                                        device="cpu")
    if nn == "grid":  # JAX's grid engine in its fixed mode
        want = jax_icp_grid(jnp.asarray(model), jnp.asarray(scene), -math.inf, max_iter=10,
                            solver=solver, with_scale=True, reference_compat=True,
                            mode="fixed", n_iters=10)
    else:
        want = jax_icp_fixed_iters(jnp.asarray(model), jnp.asarray(scene), n_iters=10,
                                   solver=solver, nn_method=nn)
    assert int(got.iters) == int(want.iters) == 10
    assert math.isnan(float(got.err)) and math.isnan(float(want.err))


def test_fixed_iters_without_nan_still_runs_every_iteration():
    model, scene = _pair(nan=False)
    for nn in ("bcast", "pallas"):
        res = icp_tpu_torch.icp_fixed_iters(model, scene, n_iters=12, solver="qcp_fused",
                                            nn_method=nn, device="cpu")
        assert int(res.iters) == 12 and float(res.err) < 1e-6


@pytest.mark.parametrize("solver", ["eigh", "qcp", "kabsch"])
def test_torch_icp_nan_gives_nan_not_an_exception(solver):
    model, scene = _pair()
    cfg = dict(max_iter=10, nn_method="bcast", solver=solver)
    got = icp_tpu_torch.icp(model, scene, icp_tpu_torch.ICPConfig(**cfg), device="cpu")
    want = icp_tpu.icp(jnp.asarray(model), jnp.asarray(scene), icp_tpu.ICPConfig(**cfg))
    assert int(got.iters) == int(want.iters) == 1
    assert math.isnan(float(got.err)) and math.isnan(float(want.err))
    with pytest.raises(FloatingPointError):
        icp_tpu_torch.icp(model, scene, icp_tpu_torch.ICPConfig(**cfg), guard=True, device="cpu")
    with pytest.raises(FloatingPointError):
        icp_tpu.icp(jnp.asarray(model), jnp.asarray(scene), icp_tpu.ICPConfig(**cfg), guard=True)


@pytest.mark.parametrize("solver", ["eigh", "kabsch"])
def test_solvers_return_nan_on_a_non_finite_matrix(solver):
    from icp_tpu_torch.ops.alignment import max_eigvec_eigh, rotation_kabsch

    fn = max_eigvec_eigh if solver == "eigh" else rotation_kabsch
    n = 4 if solver == "eigh" else 3
    a = torch.eye(n, dtype=torch.float64)
    assert torch.isfinite(fn(a)).all()
    for bad in (float("nan"), float("inf")):
        a[0, 1] = a[1, 0] = bad
        assert torch.isnan(fn(a)).all()


class _Precisions(TorchDispatchMode):
    """Records the float32 matmul precision in force at every torch op."""

    def __init__(self):
        super().__init__()
        self.seen = set()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.add(torch.get_float32_matmul_precision())
        self.ops += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _caller_sets_high():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        yield
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)


def _entry_points(tmp_path):
    model, scene = _pair(200, seed=3, nan=False)
    m_t, s_t = torch.tensor(model), torch.tensor(scene)
    cfg = icp_tpu_torch.ICPConfig(max_iter=3)
    paths = []
    for name, cloud in (("model.csv", model), ("scene.csv", scene)):
        path = tmp_path / name
        icp_tpu_torch.write_matrix(cloud, str(path))
        paths.append(str(path))
    return {
        "icp": lambda: icp_tpu_torch.icp(model, scene, cfg, device="cpu"),
        "icp_fixed_iters": lambda: icp_tpu_torch.icp_fixed_iters(model, scene, n_iters=2,
                                                                 device="cpu"),
        "icp_step": lambda: icp_tpu_torch.icp_step(s_t, m_t, solver="eigh", nn_method="bcast",
                                                   with_scale=True, reference_compat=True),
        "icp_point_to_plane": lambda: icp_tpu_torch.icp_point_to_plane(model, scene, cfg,
                                                                       device="cpu"),
        "icp_symmetric": lambda: icp_tpu_torch.icp_symmetric(model, scene, cfg, device="cpu"),
        "icp_generalized": lambda: icp_tpu_torch.icp_generalized(model, scene, cfg, device="cpu"),
        "estimate_normals": lambda: icp_tpu_torch.estimate_normals(model, device="cpu"),
        "knn_indices": lambda: knn_indices(m_t, 8),
        "find_alignment": lambda: icp_tpu_torch.find_alignment(s_t, m_t),
        "cli": lambda: cli_main([*paths, "3", "--device", "cpu",
                                 "--output", str(tmp_path / "out.txt")]),
    }


ENTRY_POINTS = ["icp", "icp_fixed_iters", "icp_step", "icp_point_to_plane", "icp_symmetric",
                "icp_generalized", "estimate_normals", "knn_indices", "find_alignment", "cli"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_compute_in_full_float32_whatever_the_caller_set(name, tmp_path):
    run = _entry_points(tmp_path)[name]
    with _caller_sets_high():
        with _Precisions() as rec:
            run()
    assert rec.ops > 0 and rec.seen == {"highest"}


@pytest.mark.parametrize("name", ["icp", "icp_point_to_plane", "estimate_normals", "cli"])
def test_the_callers_precision_is_restored_after_an_exception(name, tmp_path):
    three = np.zeros((3, 3), np.float32)
    raising = {
        "icp": lambda: icp_tpu_torch.icp(three, three, device="cpu"),
        "icp_point_to_plane": lambda: icp_tpu_torch.icp_point_to_plane(three, three,
                                                                       device="cpu"),
        "estimate_normals": lambda: icp_tpu_torch.estimate_normals(three, method="bogus",
                                                                   device="cpu"),
        "cli": lambda: cli_main(["a", "b", "not-a-number"]),
    }[name]
    with _caller_sets_high():
        with pytest.raises((ValueError, SystemExit)):
            raising()
