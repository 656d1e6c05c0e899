"""The plain reference: it recovers known motions, agrees with itself in
float64 and float32, and the control (TF32) reads far from it."""

from __future__ import annotations

import numpy as np
import pytest

from conftest import SEED
from regbench import check
from regbench.reference import icp as ref
from regbench.traffic import Generator


def _rotation(deg, axis):
    axis = np.asarray(axis, dtype=np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    a = np.radians(deg)
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K


def test_point_to_point_recovers_a_similarity(small_cell):
    model = small_cell("horse48k.p2p", step=16).source.points
    R, s, t = _rotation(3.0, [1, 2, 3]), 1.02, np.array([0.003, -0.002, 0.001])
    scene = (model - t) @ R / s  # s R scene + t = model, row for row
    ans = ref.point_to_point(model, scene, max_iter=60, threshold=1e-20)
    assert abs(ans.s - s) < 1e-9
    assert np.abs(ans.R - R).max() < 1e-9 and np.abs(ans.t - t).max() < 1e-9
    assert np.abs(ans.points - model).max() < 1e-9 and ans.err < 1e-20


def test_point_to_plane_recovers_a_rigid_motion(small_cell):
    model = small_cell("horse48k.p2p", step=16).source.points
    R, t = _rotation(2.0, [0, 1, 1]), np.array([0.002, 0.001, -0.001])
    scene = (model - t) @ R
    ans = ref.point_to_plane(model, scene, max_iter=60, threshold=1e-24)
    assert np.abs(ans.R - R).max() < 1e-8 and np.abs(ans.t - t).max() < 1e-8


def test_pca_normals_of_a_plane():
    rng = np.random.default_rng(0)
    pts = np.c_[rng.random((500, 2)), 1e-6 * rng.standard_normal(500)]
    n = ref.pca_normals(pts, 17)
    assert np.abs(np.abs(n[:, 2]) - 1).max() < 1e-3


def test_trim_threshold_keeps_at_least_the_share():
    rng = np.random.default_rng(1)
    for d2 in (rng.random(1000), rng.exponential(size=5000) ** 3):
        tau = ref.trim_threshold(d2, 0.9)
        assert (d2 <= tau).sum() >= 0.9 * d2.shape[0]
        assert (d2 <= tau).sum() <= 0.9 * d2.shape[0] + 0.05 * d2.shape[0]


def test_tf32_rounding():
    x = np.array([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-12, 1.0 + 3 * 2.0**-11])
    assert ref.tf32(x).tolist() == [1.0, 1.0 + 2.0**-10, 1.0, 1.0 + 2 * 2.0**-10]


@pytest.mark.parametrize("name", ["horse48k.p2p", "horse48k.p2p_trim", "horse1M.p2pl"])
def test_float32_rounding_moves_the_answer_far_less_than_the_control(small_cell, name):
    """The answer is stable at float32's rounding (inputs moved by a
    seeded float32 ulp), and the control (TF32) reads far from it."""
    cell = small_cell(name, step=8)
    req = Generator(cell.config, cell.mix, SEED, "cpu", cell.source).make(1)
    model, scene = req.model.double().numpy(), req.scene.double().numpy()
    diag = float(np.linalg.norm(model.max(0) - model.min(0)))
    rng = np.random.default_rng(7)
    ulp = [x * (1 + 2.0**-24 * rng.choice([-1.0, 1.0], x.shape)) for x in (model, scene)]
    a64 = check.reference_answer(cell.config, cell.mix, model, scene)
    a32 = check.reference_answer(cell.config, cell.mix, *ulp)
    low = check.reference_answer(cell.config, cell.mix, model, scene, precision="tf32")
    same = check.gaps(a32, a64, scene, diag)
    apart = check.gaps(low, a64, scene, diag)
    assert a32.iters == a64.iters
    assert same["points_gap"] < 5e-5 and same["err_gap"] < 1e-3
    assert apart["points_gap"] > 20 * same["points_gap"]


@pytest.mark.parametrize("case", ["random", "far", "duplicates", "lattice", "one"])
def test_the_block_search_is_exact(case):
    """``nn.nearest`` against brute force: the nearest row by the float64
    distance, the lowest on ties, for queries near and far."""
    from regbench.reference.nn import nearest

    rng = np.random.default_rng(3)
    if case == "lattice":  # every query equidistant from 8 rows
        model = np.stack(np.meshgrid(*[np.arange(12.0)] * 3), -1).reshape(-1, 3)
        query = model[:600] + 0.5
    elif case == "duplicates":
        half = rng.standard_normal((700, 3))
        model = np.concatenate([half, half[::-1]])
        query = half[::3] + 1e-3
    elif case == "one":
        model, query = rng.standard_normal((1, 3)), rng.standard_normal((5, 3))
    else:
        model = rng.standard_normal((3000, 3)) * [1.0, 1.0, 0.01]  # a thin slab
        query = rng.standard_normal((1100, 3)) * (30.0 if case == "far" else 1.0)
    d = ((query[:, None, :] - model[None, :, :]) ** 2).sum(-1)
    assert (nearest(model, query) == d.argmin(1)).all()


@pytest.mark.parametrize(("margin", "tie"), [(0.999, True), (0.9, False)])
def test_a_stop_at_the_threshold_is_a_tie(small_cell, margin, tie):
    """A program that stopped one iteration before the reference, where the
    reference's error there lies within ``STOP_BAND`` of the threshold, is
    held to the reference run for its own count; elsewhere it is not."""
    cell = small_cell("horse48k.p2p", step=16)
    gen = Generator(cell.config, cell.mix, SEED, "cpu", cell.source)
    req = gen.make(0 if gen.motion(0) is cell.source.motions[1] else 1)  # tr2: it converges
    model, scene = req.model.double().numpy(), req.scene.double().numpy()
    diag = float(np.linalg.norm(model.max(0) - model.min(0)))

    def run(max_iter, threshold):
        cfg = dict(cell.config, icp=dict(cell.config["icp"], max_iter=max_iter,
                                         threshold=threshold))
        return cfg, check.reference_answer(cfg, cell.mix, model, scene)

    _, third = run(3, 0.0)
    cfg, ref = run(20, third.err * margin)  # the reference goes on past 3
    assert ref.iters > 3
    held = check.reference_for(third, ref, cfg, cell.mix, model, scene)
    assert (check.gaps(third, held, scene, diag)["points_gap"] == 0.0) is tie
