"""K1-K4 on the card against their plain versions (``cuda`` marker).

These need a CUDA device and ``nvcc``; without a card they skip.  On a
machine with one:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from icp_tpu_torch.kernels import _build, icp_fused, nn_dense, nn_grid, qcp

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _cloud(seed, n, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.tensor(scale * rng.standard_normal((n, 3)), dtype=torch.float32)


@pytest.mark.parametrize("n,m", [(1, 1), (300, 2049), (5000, 700)])
def test_nn_dense_kernel_matches_plain(dev, n, m):
    s, mo = _cloud(n, n).to(dev), _cloud(m, m, 2.0).to(dev)
    mo[m // 2:] = mo[: m - m // 2].clone()  # duplicates: lowest index wins
    before = _build.LAUNCHES["nn_dense"]
    ik, dk = nn_dense.nn_dense(s, mo, with_dist=True)
    ip, dp = nn_dense.nn_dense_plain(s, mo, with_dist=True)
    assert _build.LAUNCHES["nn_dense"] == before + 1
    assert torch.equal(ik, ip) and torch.equal(dk, dp)


def test_qcp_step_kernel_matches_plain(dev):
    p, y = _cloud(1, 500).double(), _cloud(2, 500).double()
    from icp_tpu_torch.ops.alignment import compute_alignment_stats

    parts = torch.cat([qcp.pack_stats(compute_alignment_stats(a.to(dev), b.to(dev)))
                       for a, b in zip(p.chunk(7), y.chunk(7))])
    outs = []
    for fn in (qcp.qcp_step, qcp.qcp_step_plain):
        st, ctl, errs = qcp.identity_state(dev), qcp.new_loop_control(3, dev), qcp.new_err_buffer(3, dev)
        fn(parts, st, ctl, errs, threshold=1e-5)
        outs.append((st, ctl, errs))
    assert torch.equal(outs[0][1], outs[1][1])
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=1e-12)


def test_icp_fused_kernel_matches_plain(dev):
    prep = icp_fused.prepare_fused_inputs(_cloud(3, 1000).to(dev), _cloud(4, 1500).to(dev))
    ctl = qcp.new_loop_control(2, dev)
    pk = icp_fused.fused_partials(prep, qcp.identity_state(dev), ctl)
    pp = icp_fused.fused_partials_plain(prep, qcp.identity_state(dev))
    torch.testing.assert_close(pk.sum(0), pp[0], rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("cap", [16, 1])
def test_nn_grid_kernel_matches_plain_and_brute_force(dev, cap):
    model = _cloud(5, 3000).to(dev)
    scene = (_cloud(6, 1024) * 1.01).to(dev)
    grid = nn_grid.build_model_grid(model, target_tile=256)
    u = nn_grid.bound_from_indices(scene, grid, nn_grid.initial_bound_indices(scene, model))
    cand, counts, _ = nn_grid.candidates(scene, u, grid, scene_tile=128, cap=cap)
    args = (cand, counts, scene, grid.tiles, 128)
    dk, ik, yk = nn_grid.nn_grid(*args)
    dp, ip, yp = nn_grid.nn_grid_plain(*args)
    assert torch.equal(ik, ip) and torch.equal(dk, dp) and torch.equal(yk, yp)
    assert torch.equal(ik, nn_dense.nn_dense(scene, model))
