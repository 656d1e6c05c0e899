"""The dispatch sizes of ``"auto"`` on CPU tensors, against JAX's: the
normals' kNN method and the chain's bucket (the NN method and the fused
gate: ``test_torch_icp.py::test_auto_resolution_mirrors_jax`` and
``test_torch_fused.py::test_fused_path_gating``), and K3's plain version
above JAX's fused cap, which the card's cap now admits, against the
pipeline's plain answer.

The card's values are ``scripts/dispatch_sweep.py``'s measurements on the
H100; ``tests/test_torch_cuda.py::test_auto_dispatch_on_the_card`` holds
them there.
"""

import math

import numpy as np
import pytest
import torch

from icp_tpu.ops import padding as jpad
from icp_tpu_torch.engine.icp import icp_fixed_iters
from icp_tpu_torch.kernels import icp_fused, knn_dense, knn_grid, qcp
from icp_tpu_torch.ops import normals, padding

JAX_NORMALS_GRID = 16384  # icp_tpu/ops/normals.py:99


@pytest.mark.parametrize("n", [2048, JAX_NORMALS_GRID - 1, JAX_NORMALS_GRID,
                               JAX_NORMALS_GRID + 1])
def test_normals_auto_resolves_as_jax_on_the_cpu(n, monkeypatch):
    """K6 below JAX's 16,384 rows, K7 from there, on CPU tensors (the
    kernels' outputs stubbed: only the choice is under test)."""
    taken = []

    def stub(name):
        def run(*a, **k):
            taken.append(name)
            return None, torch.zeros((a[0].shape[0], 1), dtype=torch.int64)
        return run

    monkeypatch.setattr(knn_dense, "knn_dense", stub("dense"))
    monkeypatch.setattr(knn_grid, "knn_grid", stub("grid"))
    pts = torch.tensor(np.random.default_rng(n).standard_normal((n, 3)), dtype=torch.float32)
    normals.knn_indices(pts, 1)
    assert taken == ["grid" if n >= JAX_NORMALS_GRID else "dense"]
    assert normals.NORMALS_GRID_THRESHOLD == JAX_NORMALS_GRID


@pytest.mark.parametrize("sizes", [(120, 90), (40256, 40097, 31701), (500, 500), (4097,)])
def test_chain_bucket_resolves_as_jax_on_the_cpu(sizes):
    """The chain's "auto" bucket: JAX's rule on the CPU, none on the card."""
    clouds = [np.zeros((n, 3)) for n in sizes]
    assert padding.resolve_auto_bucket(clouds, "cpu") == jpad.resolve_auto_bucket(clouds)
    assert padding.resolve_auto_bucket(clouds, torch.device("cpu")) \
        == jpad.resolve_auto_bucket(clouds)
    assert padding.resolve_auto_bucket(clouds, "cuda") is None


def test_fused_plain_above_jax_cap_matches_the_pipeline():
    """K3's plain version (``fused_partials_plain`` + ``qcp_step_plain``)
    on a 6,000-row model, above JAX's 5,120 (the CPU's cap, so
    ``icp_fixed_iters`` takes the pipeline: K1's plain version, the float64
    sums, K2's), 8 iterations from the identity.  K3 orders neighbours in
    the float32 expansion form where K1 takes differences, so a row may
    take another neighbour within float32 rounding: transforms within
    1e-6, errors within 1e-5 relative."""
    rng = np.random.default_rng(6000)
    model = rng.standard_normal((6000, 3)).astype(np.float32)
    rows = rng.choice(6000, 2000, replace=False)
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    rot = np.eye(3) + np.sin(0.05) * K + (1 - np.cos(0.05)) * K @ K  # 2.9 degrees
    noise = 0.01 * rng.standard_normal((2000, 3))
    scene = (1.02 * (model[rows] + noise) @ rot.T + 0.01).astype(np.float32)
    n_iters = 8
    assert model.shape[0] > icp_fused.MAX_FUSED_MODEL

    prep = icp_fused.prepare_fused_inputs(torch.tensor(scene), torch.tensor(model))
    state = qcp.identity_state()
    ctl, errs = qcp.new_loop_control(n_iters), qcp.new_err_buffer(n_iters)
    for _ in range(n_iters):
        icp_fused.fused_icp_step(prep, state, ctl, errs, threshold=-math.inf, err_factor=2.0,
                                 converge=False)
    s, R_k3, t = qcp.unpack_state(state)[1]

    pipe = icp_fixed_iters(model, scene, n_iters=n_iters, solver="qcp_fused",
                           nn_method="pallas", device="cpu")
    assert int(ctl[0]) == int(pipe.iters) == n_iters
    np.testing.assert_allclose(float(s), float(pipe.transform.s), atol=1e-6)
    np.testing.assert_allclose(R_k3.numpy(), pipe.transform.R.double().numpy(), atol=1e-6)
    np.testing.assert_allclose(t.numpy(), pipe.transform.t.double().numpy(), atol=1e-6)
    np.testing.assert_allclose(float(errs[-1]), float(pipe.err), rtol=1e-5)
