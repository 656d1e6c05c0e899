"""The port's spans and counters (``icp_tpu_torch/utils/profiling.py``) on
the CPU: the span tree of each registration path under ``torch.profiler``,
nothing entered or counted without it, answers bit-identical either way,
K4's and K7's counters against their tables, the plane loop's gated
no-ops, the six per-layer metrics of a small traced ``regbench`` cell, and
GICP's inner span ``icp.gicp.step`` inside its grid loop."""

import dataclasses
import math
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import icp_tpu_torch
from icp_tpu_torch import ICPConfig
from icp_tpu_torch.engine.icp import _CHUNK
from icp_tpu_torch.kernels import knn_grid, nn_grid
from icp_tpu_torch.ops import normals
from icp_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPANS = {"icp.register", "icp.prologue", "icp.normals.knn", "icp.normals.pca",
         "icp.setup.model_grid", "icp.setup.scene_sort", "icp.setup.seed", "icp.loop",
         "icp.finish", "icp.host_wait"}
SETUP = {"icp.setup.model_grid", "icp.setup.scene_sort", "icp.setup.seed"}


def _rot_z(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


@pytest.fixture(scope="module")
def clouds():
    """cow_ref and a copy turned 0.01 rad and shifted (point-to-plane
    converges in 2 iterations on it, point-to-point in 7 on cow_tr1)."""
    ref = np.loadtxt(os.path.join(ROOT, "data", "cow_ref.txt"), skiprows=1, delimiter=",")
    tr1 = np.loadtxt(os.path.join(ROOT, "data", "cow_tr1.txt"), skiprows=1, delimiter=",")
    moved = ref @ _rot_z(0.01).T + np.array([0.001, -0.002, 0.0005])
    return ref, tr1, moved


# path -> (entry, config, the spans its registration must hold besides
# icp.register, icp.prologue, icp.loop, icp.finish and icp.host_wait)
PATHS = {
    "fused": ("icp", dict(solver="qcp_fused", nn_method="pallas"), set()),
    "pipeline": ("icp", dict(solver="qcp_fused", nn_method="pallas", trim_fraction=0.1), set()),
    "plain": ("icp", dict(solver="eigh", nn_method="bcast"), set()),
    "grid": ("icp", dict(solver="qcp_fused", nn_method="grid"), SETUP),
    "plane_grid": ("icp_point_to_plane", dict(nn_method="grid"),
                   SETUP | {"icp.normals.knn", "icp.normals.pca"}),
}


def _register(path, clouds):
    entry, kw, _ = PATHS[path]
    ref, tr1, moved = clouds
    scene = moved if entry == "icp_point_to_plane" else tr1
    return getattr(icp_tpu_torch, entry)(ref, scene, ICPConfig(max_iter=30, **kw), device="cpu")


@pytest.fixture(scope="module")
def runs(clouds):
    """path -> (untraced result, traced result, traced icp.* events, counters)."""
    out = {}
    for path in PATHS:
        off = _register(path, clouds)
        profiling.reset_counters()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            on = _register(path, clouds)
        events = [e for e in prof.events() if e.name.startswith("icp.")]
        out[path] = (off, on, events, profiling.counters())
    profiling.reset_counters()
    return out


def _icp_parent(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith("icp."):
        p = p.cpu_parent
    return p


@pytest.mark.parametrize("path", list(PATHS))
def test_span_tree_under_the_profiler(runs, path):
    _, _, events, c = runs[path]
    roots = [e for e in events if e.name == "icp.register"]
    assert len(roots) == 1 and _icp_parent(roots[0]) is None
    assert {e.name for e in events} <= SPANS
    want = {"icp.prologue", "icp.loop", "icp.finish", "icp.host_wait"} | PATHS[path][2]
    assert {e.name for e in events} == want | {"icp.register"}
    for e in events:
        parent = _icp_parent(e)
        if e.name == "icp.host_wait":
            assert parent is not None and parent.name != "icp.register"
        elif e.name != "icp.register":  # the phases lie side by side under the root
            assert parent is roots[0], (e.name, parent and parent.name)
    assert c["registrations"] == 1
    assert set(c["phase_ms"]) == want - {"icp.host_wait"} | {"icp.register"}
    assert all(v > 0 for v in c["phase_ms"].values())
    inside = sum(v for k, v in c["phase_ms"].items() if k != "icp.register")
    assert inside <= c["phase_ms"]["icp.register"]


@pytest.mark.parametrize("path", list(PATHS))
def test_answers_bit_identical_with_tracing_on_and_off(runs, path):
    off, on, _, c = runs[path]
    assert torch.equal(off.points, on.points) and torch.equal(off.err, on.err)
    assert int(off.iters) == int(on.iters) == c["iters_done"]
    for a, b in zip(off.transform, on.transform):
        assert torch.equal(a, b)


def test_no_span_and_no_count_without_the_profiler(clouds, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span was entered with the profiler off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_range", refuse)
    profiling.reset_counters()
    for path in PATHS:
        _register(path, clouds)
    assert profiling.counters() == {"phase_ms": {}}


def test_host_waits_of_the_loops(runs):
    """A flag read a chunk on the kernel paths (with the state and control
    copies of the prologue), a read an iteration on the plain one."""
    for path in ("fused", "pipeline", "grid", "plane_grid"):
        c = runs[path][3]
        assert c["iters_launched"] == _CHUNK * math.ceil(c["iters_done"] / _CHUNK)
    plain = runs["plain"][3]
    assert plain["host_waits"] >= plain["iters_launched"] + plain["iters_done"]


def record_tables(monkeypatch):
    """Keep (counts, capacity, nj, tm, tn) of each K4 and K7 launch, as
    (K4's list, K7's list); nothing is read until the caller reads it."""
    k4, k7, rec4, rec7 = nn_grid.nn_grid, knn_grid.knn_worklist, [], []

    def nn_grid_rec(cand, counts, scene, grid, scene_tile, payload=None):
        rec4.append((counts, cand.shape[1], grid.tiles.shape[0], grid.tiles.shape[1], scene_tile))
        return k4(cand, counts, scene, grid, scene_tile, payload)

    def knn_rec(cand, counts, query, tiles, scene_tile, k, bound=None):
        rec7.append((counts, cand.shape[1], tiles.shape[0], tiles.shape[1], scene_tile))
        return k7(cand, counts, query, tiles, scene_tile, k, bound)

    monkeypatch.setattr(nn_grid, "nn_grid", nn_grid_rec)
    monkeypatch.setattr(knn_grid, "knn_worklist", knn_rec)
    return rec4, rec7


def _table_counts(rec, prefix):
    """The counters of each recorded launch, counted from its table tile by
    tile: a tile past the capacity folds all nj tiles, any other its count
    (at least one); the pairs as if no item were skipped."""
    out = dict.fromkeys([f"{prefix}_rows", f"{prefix}_items", f"{prefix}_pairs",
                         f"{prefix}_table_pairs", f"{prefix}_tiles",
                         f"{prefix}_tiles_past_cap"], 0)
    for counts, cap, nj, tm, tn in rec:
        tiles = [nj if c > cap else max(c, 1) for c in counts.tolist()]
        out[f"{prefix}_rows"] += len(tiles) * tn
        out[f"{prefix}_items"] += sum(tiles)
        out[f"{prefix}_pairs"] += sum(tiles) * tm * tn
        out[f"{prefix}_table_pairs"] += sum(tiles) * tm * tn
        out[f"{prefix}_tiles"] += len(tiles)
        out[f"{prefix}_tiles_past_cap"] += sum(c > cap for c in counts.tolist())
    return out


def test_k4_and_k7_counters_equal_their_tables(clouds, monkeypatch):
    """The grid plane run with small capacities, so tiles pass them: the
    counters equal what each launch's candidate table folds (K4's plain
    version, on the CPU, skips no item)."""
    rec4, rec7 = record_tables(monkeypatch)
    ref, _, moved = clouds
    nv = normals.estimate_normals(torch.as_tensor(ref, dtype=torch.float32), method="dense")
    cfg = ICPConfig(max_iter=30, nn_method="grid", grid_max_candidates=2)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        icp_tpu_torch.icp_point_to_plane(ref, moved, cfg, normals=nv, device="cpu")
        normals.estimate_normals(ref, method="grid", grid_max_candidates=2, device="cpu")
    c = profiling.counters()
    profiling.reset_counters()
    want4, want7 = _table_counts(rec4, "k4"), _table_counts(rec7, "k7")
    assert want4["k4_tiles_past_cap"] > 0 and len(rec7) == 2
    assert {k: c[k] for k in want4} == want4 and c["k4_items_skipped"] == 0
    assert (c["k7_rows"], c["k7_pairs"]) == (want7["k7_rows"], want7["k7_pairs"])
    assert "k7_tiles" not in c and "k7_items" not in c


def test_k4_skipped_item_pct_reads_the_cpu_counters(clouds):
    """The reader of ``k4_skipped_item_pct`` on a traced CPU grid run: K4's
    plain version skips nothing, so 0%, within [0, 100]; untraced, None."""
    from regbench.run import read_metric

    ref, tr1, _ = clouds
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        icp_tpu_torch.icp(ref, tr1, ICPConfig(max_iter=30, nn_method="grid"), device="cpu")
    got = read_metric("k4_skipped_item_pct", types.SimpleNamespace(trace=object()))
    c = profiling.counters()
    profiling.reset_counters()
    assert c["k4_items"] > 0 and got == 0.0 and 0.0 <= got <= 100.0
    assert read_metric("k4_skipped_item_pct", types.SimpleNamespace(trace=None)) is None


def test_noop_iterations_of_a_plane_run_that_converges_in_2(clouds):
    ref, _, moved = clouds
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        res = icp_tpu_torch.icp_point_to_plane(ref, moved, ICPConfig(max_iter=30), device="cpu")
    c = profiling.counters()
    profiling.reset_counters()
    assert int(res.iters) == 2 == c["iters_done"]
    assert c["iters_launched"] - c["iters_done"] == _CHUNK - 2


def test_a_traced_regbench_cell_reports_the_six_metrics(monkeypatch):
    """``horse1M.p2pl`` cut as ``regbench``'s contract test cuts it, on the
    grid path with K7 normals (thresholds lowered for the small clouds)."""
    from regbench import run

    monkeypatch.setattr(normals, "NORMALS_GRID_THRESHOLD", 256)
    cell = run.load_cell("horse1M.p2pl")
    pts = cell.source.points[::128]
    config = dict(cell.config, rows=len(pts), icp=dict(cell.config["icp"], nn_method="grid"))
    cell = dataclasses.replace(cell, source=cell.source._replace(points=pts), config=config,
                               limits=dict(cell.limits, sample=1))
    profiling.reset_counters()
    out = run.run_cell(cell, 4100000007, 0.05, True, "cpu")
    profiling.reset_counters()
    m = {k: v["value"] for k, v in out["metrics"].items()}
    six = ("setup_pct", "noop_iter_pct", "host_waits_per_reg", "k4_pairs_per_query",
           "k4_past_capacity_pct", "k7_pairs_per_query")
    assert set(six) <= set(m) and all(math.isfinite(m[k]) for k in six), m
    assert 0 < m["setup_pct"] < 100 and 0 <= m["noop_iter_pct"] < 100
    assert 0 <= m["k4_past_capacity_pct"] <= 100 and 0 <= m["k4_skipped_item_pct"] <= 100
    assert m["host_waits_per_reg"] >= 1
    assert m["k4_pairs_per_query"] > 0 and m["k7_pairs_per_query"] > 0
    assert out["correct"] is True


GICP_STEP = "icp.gicp.step"
GICP_GRID_PHASES = {"icp.prologue", "icp.loop", "icp.finish", "icp.normals.knn",
                    "icp.normals.pca"} | SETUP


def _gicp_grid(clouds):
    ref, _, moved = clouds
    return icp_tpu_torch.icp_generalized(ref, moved, ICPConfig(max_iter=30, nn_method="grid"),
                                         device="cpu")


@pytest.fixture(scope="module")
def gicp_grid(clouds):
    """(untraced result, traced result, traced icp.* events, counters) of
    GICP's grid loop (both clouds' normals, K4 with the normals payload)."""
    off = _gicp_grid(clouds)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = _gicp_grid(clouds)
    events = [e for e in prof.events() if e.name.startswith("icp.")]
    c = profiling.counters()
    profiling.reset_counters()
    return off, on, events, c


def test_gicp_grid_span_tree_under_the_profiler(gicp_grid):
    """The phases lie side by side under the root, as on every path;
    ``icp.gicp.step`` lies directly under ``icp.loop``, twice each launched
    iteration (the rows and step, then the scene covariances' rotation),
    and its ms go to ``inner_ms``, not to ``phase_ms``."""
    _, _, events, c = gicp_grid
    roots = [e for e in events if e.name == "icp.register"]
    assert len(roots) == 1 and _icp_parent(roots[0]) is None
    names = {e.name for e in events}
    assert names == GICP_GRID_PHASES | {"icp.register", "icp.host_wait", GICP_STEP}
    steps = [e for e in events if e.name == GICP_STEP]
    for e in events:
        parent = _icp_parent(e)
        if e.name == "icp.host_wait":
            assert parent is not None and parent.name != "icp.register"
        elif e.name == GICP_STEP:
            assert parent is not None and parent.name == "icp.loop"
        elif e.name != "icp.register":
            assert parent is roots[0], (e.name, parent and parent.name)
    assert c["registrations"] == 1 and c["iters_launched"] >= c["iters_done"] >= 1
    assert len(steps) == 2 * c["iters_launched"]
    assert set(c["phase_ms"]) == GICP_GRID_PHASES | {"icp.register"}
    assert set(c["inner_ms"]) == {GICP_STEP}
    assert 0 < c["inner_ms"][GICP_STEP] <= c["phase_ms"]["icp.loop"]
    inside = sum(v for k, v in c["phase_ms"].items() if k != "icp.register")
    assert inside <= c["phase_ms"]["icp.register"]


def test_gicp_grid_answers_bit_identical_with_tracing_on_and_off(gicp_grid):
    off, on, _, c = gicp_grid
    assert torch.equal(off.points, on.points) and torch.equal(off.err, on.err)
    assert int(off.iters) == int(on.iters) == c["iters_done"]
    for a, b in zip(off.transform, on.transform):
        assert torch.equal(a, b)


def test_no_inner_span_without_the_profiler(clouds, monkeypatch):
    """GICP's grid loop with the profiler off enters no span, and the
    counters carry no ``inner_ms``."""
    def refuse(*args, **kwargs):
        raise AssertionError("a span was entered with the profiler off")

    monkeypatch.setattr(profiling, "_range", refuse)
    profiling.reset_counters()
    _gicp_grid(clouds)
    assert profiling.counters() == {"phase_ms": {}}
