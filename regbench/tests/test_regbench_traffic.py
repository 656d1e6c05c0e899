"""The request generator: requests are a function of the seed and the
index, the scenes are the source's own motions of the base cloud, and the
1M draws sample the base's surface."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import SEED
from regbench.traffic import Generator, load_points, load_source, tangent_frames


def _gen(cell, seed=SEED, mix=None):
    return Generator(cell.config, cell.mix if mix is None else mix, seed, "cpu", cell.source)


@pytest.mark.parametrize("name", ["horse48k.p2p_trim", "horse1M.p2pl"])
def test_requests_are_a_function_of_seed_and_index(small_cell, name):
    cell = small_cell(name)
    a, b = _gen(cell).make(5), _gen(cell).make(5)
    assert torch.equal(a.model, b.model) and torch.equal(a.scene, b.scene)
    assert not torch.equal(a.scene, _gen(cell).make(7).scene)
    assert not torch.equal(a.scene, _gen(cell, SEED + 2).make(5).scene)
    for seed in (2**40 + 3, -5, 0):  # any whole number
        assert torch.isfinite(_gen(cell, seed).make(0).scene).all()


@pytest.mark.parametrize("config", ["horse48k", "horse1M"])
def test_the_motions_are_the_sources_own(config):
    """Each motion moves the base onto its source file, row for row, and
    requests take them in turn from a seeded start."""
    with open(f"regbench/configs/{config}.json") as f:
        cfg = json.load(f)
    src = load_source(cfg)
    assert len(src.motions) == 2
    for (s, R, t), rel in zip(src.motions, cfg["motions"]):
        moved = load_points(rel)
        assert np.abs(s * src.points @ R.T + t - moved).max() < 1e-6
        assert np.allclose(R @ R.T, np.eye(3), atol=1e-12) and np.linalg.det(R) > 0
    gen = Generator(dict(cfg, rows=64, surface_radius=0.0), {}, SEED, "cpu",
                    src._replace(points=src.points[:64]))
    used = [gen.motion(i) for i in range(6)]
    assert used[0] is not used[1] and used[0] is used[2] and used[1] is used[3]


def test_a_changed_source_file_is_refused(tmp_path, monkeypatch):
    with open("regbench/configs/horse48k.json") as f:
        cfg = json.load(f)
    bad = dict(cfg["sha256"], **{cfg["points"]: "0" * 64})
    with pytest.raises(SystemExit, match="SHA-256"):
        load_source(dict(cfg, sha256=bad))


def test_the_fixed_model_is_the_base(small_cell):
    fixed = small_cell("horse48k.p2p")
    gen = _gen(fixed)
    assert gen.make(0).model is gen.make(1).model
    assert torch.equal(gen.make(0).model, torch.as_tensor(fixed.source.points, dtype=torch.float32))


def test_a_surface_draw_stays_in_the_tangent_discs(small_cell):
    cell = small_cell("horse1M.p2p", step=8)
    cfg = dict(cell.config, rows=4 * cell.source.points.shape[0])
    gen = Generator(cfg, cell.mix, SEED, "cpu", cell.source)
    m0, m1 = gen.make(0).model.double(), gen.make(1).model.double()
    assert m0.shape == (cfg["rows"], 3) and not torch.equal(m0, m1)
    off = (m0 - gen.base).numpy()
    u, v = tangent_frames(cell.source.points, cfg["surface_k"])
    n = np.cross(u, v)[np.arange(cfg["rows"]) % u.shape[0]]
    r = np.linalg.norm(off, axis=1)
    assert r.max() <= cfg["surface_radius"] * (1 + 1e-4)
    assert np.abs((off * n).sum(1)).max() < 3e-5 * cfg["surface_radius"]  # float32 rounding
    # uniform in the disc: the median radius is radius / sqrt(2)
    assert abs(np.median(r) / cfg["surface_radius"] - 2**-0.5) < 0.03


def test_the_scene_is_the_moved_jittered_base(small_cell):
    cell = small_cell("horse48k.p2p")
    gen = _gen(cell)
    req = gen.make(3)
    s, R, t = gen.motion(3)
    back = (req.scene.double().numpy() - t) @ R / s
    noise = back - cell.source.points
    assert abs(noise.std() - cell.config["scene_jitter"]) < 1e-5
    assert abs(noise.mean()) < 2e-5


def test_clutter_replaces_the_stated_share_inside_the_enlarged_box(small_cell):
    cell = small_cell("horse48k.p2p_trim", step=8)
    clean = dict(cell.mix, clutter_fraction=0.0)
    with_clutter, without = _gen(cell).make(2), _gen(cell, mix=clean).make(2)
    moved = (with_clutter.scene != without.scene).any(1)
    n = cell.source.points.shape[0]
    assert int(moved.sum()) == round(0.1 * n)
    m = with_clutter.model
    lo, hi = m.amin(0), m.amax(0)
    half = 0.5 * (hi - lo) * cell.mix["clutter_box_scale"]
    c = with_clutter.scene[moved]
    assert bool(((c >= 0.5 * (lo + hi) - half - 1e-6) & (c <= 0.5 * (lo + hi) + half + 1e-6)).all())
