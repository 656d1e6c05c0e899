"""The port's Generalized-ICP (``icp_generalized``) against the benchmark's
plain GICP reference (``regbench/reference/gicp.py``) on the CPU, at the
``horse1M.gicp`` cell cut to every 64th row of its base cloud (as
``regbench/tests/conftest.py``'s ``small_cell`` cuts it); the reference
alone; and the two readers of the GICP step's span.  Nothing here imports
JAX or the JAX package."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import icp_tpu_torch
from icp_tpu_torch import ICPConfig
from icp_tpu_torch.utils import profiling
from regbench import check, roofline, run
from regbench.reference import gicp as ref
from regbench.reference import icp as plain
from regbench.traffic import Generator

SEED = 2**31 + 1234567  # past 32 signed bits, as the benchmark's seeds may be
STEP = 64  # every 64th base row: 758 rows, the base's own density

# The cell's points and transform limits (``regbench/limits/horse1M.gicp.json``),
# which hold at this size too: the four cases below read at most 1.4e-6.
# The cell's ``err_gap`` limit is 4e-2 (its sound readings at 1M reach
# 1.1e-2); here the cases read at most 3.7e-3, from float32 near-ties in the
# matching that move the error at GICP's stop (the port in float64 with an
# exact float64 search is the reference to 1e-12, below), so the tighter 1e-2.
POINTS_GAP = 5e-5
TRANSFORM_GAP = 8e-6
ERR_GAP = 1e-2
# The port's loops: "pallas" is the dense loop (K1's plain version on
# CPU tensors); "grid" with small tiles, so that the 758 rows span many.
PATHS = {"dense": dict(nn_method="pallas"),
         "grid": dict(nn_method="grid", grid_scene_tile=32, grid_model_tile=64)}


@pytest.fixture(scope="module")
def cell():
    cell = run.load_cell("horse1M.gicp")
    pts = cell.source.points[::STEP]
    return dataclasses.replace(cell, source=cell.source._replace(points=pts),
                               config=dict(cell.config, rows=pts.shape[0]))


def _request(cell, motion: int):
    """The cut cell's request that applies the source's motion ``motion``."""
    gen = Generator(cell.config, cell.mix, SEED, "cpu", cell.source)
    i = next(i for i in range(2) if gen.motion(i) is cell.source.motions[motion])
    return gen.make(i)


@pytest.mark.parametrize("motion", [0, 1])
@pytest.mark.parametrize("path", list(PATHS))
def test_the_port_answers_as_the_reference(cell, path, motion):
    """The cell's registration (float32, "auto" replaced by the path) held
    to the reference's float64 answer as ``correct`` holds it: the same
    iterations, or a stop tie (``check.reference_for``)."""
    req = _request(cell, motion)
    cfg = ICPConfig(dtype=torch.float32, **dict(cell.config["icp"], **PATHS[path]))
    res = icp_tpu_torch.icp_generalized(req.model, req.scene, cfg, **cell.mix["kwargs"])
    out = check.output_of(0, res)
    model, scene = req.model.double().numpy(), req.scene.double().numpy()
    want = check.reference_answer(cell.config, cell.mix, model, scene)
    held = check.reference_for(out, want, cell.config, cell.mix, model, scene)
    assert out.iters == want.iters or (abs(out.iters - want.iters) == 1 and held is not want)
    diag = float(np.linalg.norm(model.max(0) - model.min(0)))
    gap = check.gaps(out, held, scene, diag)
    assert gap["points_gap"] < POINTS_GAP, gap
    assert gap["transform_gap"] < TRANSFORM_GAP, gap
    assert gap["err_gap"] < ERR_GAP, gap


@pytest.mark.parametrize("motion", [0, 1])
def test_the_port_in_float64_is_the_reference(cell, motion):
    """The same registration in float64 through the dense loop with the
    brute-force float64 search ("bcast"): the same mathematics, so the same
    answer to float64's rounding, iteration by iteration."""
    req = _request(cell, motion)
    cfg = ICPConfig(dtype=torch.float64, **dict(cell.config["icp"], nn_method="bcast"))
    res = icp_tpu_torch.icp_generalized(req.model.double(), req.scene.double(), cfg,
                                        **cell.mix["kwargs"])
    out = check.output_of(0, res)
    model, scene = req.model.double().numpy(), req.scene.double().numpy()
    want = check.reference_answer(cell.config, cell.mix, model, scene)
    diag = float(np.linalg.norm(model.max(0) - model.min(0)))
    gap = check.gaps(out, want, scene, diag)
    assert out.iters == want.iters >= 3
    assert max(gap.values()) < 1e-10, gap


def _rotation(deg, axis):
    axis = np.asarray(axis, dtype=np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    a = np.radians(deg)
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K


def test_the_identity_motion_gives_the_identity(cell):
    pts = _request(cell, 0).model.double().numpy()
    ans = ref.gicp(pts, pts.copy(), max_iter=20, threshold=1e-5)
    assert ans.iters == 1 and ans.err == 0.0
    assert np.array_equal(ans.R, np.eye(3)) and np.array_equal(ans.t, np.zeros(3))
    assert np.array_equal(ans.points, pts)


def test_the_reference_recovers_a_rigid_motion(cell):
    model = cell.source.points[::2]
    R, t = _rotation(2.0, [0, 1, 1]), np.array([0.002, 0.001, -0.001])
    ans = ref.gicp(model, (model - t) @ R, max_iter=60, threshold=1e-24)
    assert np.abs(ans.R - R).max() < 1e-8 and np.abs(ans.t - t).max() < 1e-8


@pytest.mark.parametrize("precision", ["float64", "tf32"])
def test_a_normals_sign_changes_nothing(cell, precision):
    """The disk covariance ``I - (1 - eps) n n^T`` is the same for ``-n``:
    flipping the sign of any rows' normals, of either cloud, gives the
    same answer bit for bit."""
    req = _request(cell, 1)
    model, scene = req.model.double().numpy(), req.scene.double().numpy()
    nm = plain.pca_normals(model, 17, precision)
    ns = plain.pca_normals(scene, 17, precision)
    rng = np.random.default_rng(5)
    flip = [np.where(rng.random((n.shape[0], 1)) < 0.5, -1.0, 1.0) for n in (nm, ns)]
    kw = dict(max_iter=20, threshold=1e-5, precision=precision)
    a = ref.gicp(model, scene, model_normals=nm, scene_normals=ns, **kw)
    b = ref.gicp(model, scene, model_normals=flip[0] * nm, scene_normals=flip[1] * ns, **kw)
    assert a.iters == b.iters >= 1
    for x, y in zip(a, b):
        assert np.array_equal(x, y), (x, y)


def test_the_control_reads_far_from_the_reference(cell):
    """The reference one precision below (TF32) moves the answer far more
    than float32's rounding of the inputs does."""
    req = _request(cell, 0)
    model, scene = req.model.double().numpy(), req.scene.double().numpy()
    diag = float(np.linalg.norm(model.max(0) - model.min(0)))
    rng = np.random.default_rng(7)
    ulp = [x * (1 + 2.0**-24 * rng.choice([-1.0, 1.0], x.shape)) for x in (model, scene)]
    a64 = check.reference_answer(cell.config, cell.mix, model, scene)
    a32 = check.reference_answer(cell.config, cell.mix, *ulp)
    low = check.reference_answer(cell.config, cell.mix, model, scene, precision="tf32")
    same, apart = check.gaps(a32, a64, scene, diag), check.gaps(low, a64, scene, diag)
    assert a32.iters == a64.iters
    assert apart["points_gap"] > 20 * same["points_gap"]


ROWS = 1_000_000


def _read(name, counters, monkeypatch, traced=True):
    monkeypatch.setattr(profiling, "counters", lambda: counters)
    trace = types.SimpleNamespace(config={"rows": ROWS}) if traced else None
    return run.read_metric(name, run.RunRecord(setup_s=1.0, window=run.Window(), trace=trace))


def test_the_step_readers_on_synthetic_counters(monkeypatch):
    c = {"registrations": 2, "iters_launched": 16, "iters_done": 9,
         "phase_ms": {"icp.register": 200.0, "icp.loop": 120.0},
         "inner_ms": {"icp.gicp.step": 50.0}}
    assert _read("gicp_step_pct", c, monkeypatch) == pytest.approx(25.0, rel=1e-15)
    # 16 launched iterations x 1,000,000 rows x 76 B at 3.35 TB/s, over 50 ms
    want = 100.0 * (16 * 1_000_000 * 76 / 3.35e12) / 0.050
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert _read("gicp_step_roofline_pct", c, monkeypatch) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(0.72597, rel=1e-4)


@pytest.mark.parametrize("name", ["gicp_step_pct", "gicp_step_roofline_pct"])
def test_the_step_readers_read_nothing_without_the_span(monkeypatch, name):
    """A program with no ``inner_ms`` (an engine without the span, or a
    program older than it) and an untraced run give None."""
    c = {"registrations": 2, "iters_launched": 16, "phase_ms": {"icp.register": 200.0}}
    assert _read(name, c, monkeypatch) is None
    assert _read(name, dict(c, inner_ms={"icp.other": 1.0}), monkeypatch) is None
    full = dict(c, inner_ms={"icp.gicp.step": 50.0})
    assert _read(name, full, monkeypatch, traced=False) is None
