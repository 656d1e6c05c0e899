"""References and roofline inputs are found by name in data and files of
their own: a traffic mix's ``reference`` is the module
``reference/<name>.py``, and its ``k4_payload_cols`` and ``k7_searches``
state what rides K4 and K7, so a cell on a new engine needs no edit of
``check.py``, ``control.py``, ``run.py`` or a reader."""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from conftest import ROOT, SEED
from regbench import check, control, roofline, run
from regbench.reference import icp as plain
from regbench.trace import Trace
from regbench.traffic import Generator

PKG = os.path.join(ROOT, "regbench")


def _mix(name: str) -> dict:
    with open(os.path.join(PKG, "traffic", f"{name}.json")) as f:
        return json.load(f)


def _as_named_before(config, mix, model, scene, precision):
    """The reference's answer as ``check.reference_answer`` gave it while
    it kept the two names itself."""
    icp = dict(config["icp"], **mix.get("icp", {}))
    kw = dict(max_iter=int(icp["max_iter"]), threshold=float(icp["threshold"]),
              precision=precision, device="cpu")
    if mix["reference"] == "point_to_point":
        return plain.point_to_point(
            model, scene, err_factor=2.0 if icp.get("reference_compat", True) else 1.0,
            trim_fraction=float(icp.get("trim_fraction", 0.0)), **kw)
    assert mix["reference"] == "point_to_plane"
    return plain.point_to_plane(model, scene, normal_k=int(mix["kwargs"]["normal_k"]), **kw)


@pytest.mark.parametrize("precision", ["float64", "tf32"])
@pytest.mark.parametrize("name", ["horse48k.p2p", "horse1M.p2pl", "horse48k.p2p_trim"])
def test_a_reference_found_by_name_answers_as_before(small_cell, name, precision):
    cell = small_cell(name, step=16)
    req = Generator(cell.config, cell.mix, SEED, "cpu", cell.source).make(0)
    model, scene = req.model.double().numpy(), req.scene.double().numpy()
    got = check.reference_answer(cell.config, cell.mix, model, scene, precision=precision)
    want = _as_named_before(cell.config, cell.mix, model, scene, precision)
    assert type(got) is plain.Answer and got.iters == want.iters >= 1
    for a, b in zip(got, want):
        assert np.array_equal(a, b), (a, b)


def _stand_in(monkeypatch, calls):
    """A reference that no file holds, placed as ``regbench.reference.stand_in``:
    it records its arguments and answers as point-to-point does."""
    mod = types.ModuleType("regbench.reference.stand_in")

    def answer(model, scene, icp, kwargs, *, precision, device):
        calls.append({"icp": icp, "kwargs": kwargs, "precision": precision})
        return plain.point_to_point(model, scene, max_iter=int(icp["max_iter"]),
                                    threshold=float(icp["threshold"]), precision=precision,
                                    device=device)

    mod.answer = answer
    monkeypatch.setitem(sys.modules, mod.__name__, mod)


def test_a_stand_in_reference_is_used_by_compare_and_the_control(small_cell, monkeypatch):
    calls = []
    _stand_in(monkeypatch, calls)
    cell = small_cell("horse48k.p2p", step=64)
    mix = dict(cell.mix, reference="stand_in", icp={"max_iter": 3}, kwargs={"tag": 1})
    cell = dataclasses.replace(cell, mix=mix)
    gen = Generator(cell.config, mix, SEED, "cpu", cell.source)
    outputs = []
    for i in (0, 1):
        req = gen.make(i)
        a = plain.point_to_point(req.model.double().numpy(), req.scene.double().numpy(),
                                 max_iter=3, threshold=float(cell.config["icp"]["threshold"]))
        outputs.append(check.Output(i, a.points, a.s, a.R, a.t, a.err, a.iters))
    checked, worst = check.compare(outputs, gen.make, cell.config, mix, cell.limits)
    assert worst["points_gap"] == worst["err_gap"] == 0.0 and worst["transform_gap"] < 1e-12
    assert checked
    assert [c["precision"] for c in calls] == ["float64", "float64"]
    assert all(c["icp"]["max_iter"] == 3 and c["kwargs"] == {"tag": 1} for c in calls)
    assert calls[0]["icp"]["threshold"] == cell.config["icp"]["threshold"]
    calls.clear()
    control.readings(cell, SEED, "cpu", requests=1)
    assert sorted(c["precision"] for c in calls) == ["float64", "tf32"]


ABSENT = object()  # stands for a plain name that no file of ``reference/`` has


def _absent_name() -> str:
    """A plain identifier that names no module of ``reference/``, whichever
    reference files are there."""
    taken = {f.rpartition(".")[0] for f in os.listdir(os.path.join(PKG, "reference"))}
    name = "no_such_reference"
    while name in taken:
        name += "_"
    return name


@pytest.mark.parametrize("bad", [ABSENT, "icp", "nn", "__init__", "../check", "point_to_point.py",
                                 "", None])
def test_a_mix_naming_no_reference_fails_to_load(monkeypatch, bad):
    """A name with no module of ``reference/``, a module there that defines
    no ``answer`` (the shared code), or a name that is no plain identifier
    fails in ``load_cell``, and the message lists every reference there is."""
    bad = _absent_name() if bad is ABSENT else bad
    real = run._load_json

    def load(path):
        got = real(path)
        return dict(got, reference=bad) if os.sep + "traffic" + os.sep in path else got

    monkeypatch.setattr(run, "_load_json", load)
    with pytest.raises(SystemExit) as exc:
        run.load_cell("horse1M.p2pl")
    msg = str(exc.value)
    refs = check.references()
    assert {"point_to_plane", "point_to_point"} <= set(refs) and bad not in refs
    assert all(r in msg for r in refs) and repr(bad) in msg


def test_loading_every_cell_imports_no_reference_and_no_scipy():
    code = ("import json, sys; from regbench import run; "
            "cells = [w['name'] for w in json.load(open('BENCHMARK.json'))['workloads']]; "
            "[run.load_cell(c) for c in cells]; "
            "print(sorted(m for m in sys.modules if m.startswith('regbench.reference') "
            "or m.partition('.')[0] == 'scipy'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_harness_names_no_reference_and_no_reader_reads_one():
    """``check.py``, ``control.py`` and ``run.py`` hold no reference's name;
    no metric reader reads the mix's ``reference``."""
    names = set(check.references())
    for f in ("check.py", "control.py", "run.py"):
        tree = ast.parse(open(os.path.join(PKG, f)).read())
        consts = {n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)}
        assert not names & consts, f
    for f in os.listdir(os.path.join(PKG, "metrics")):
        assert '"reference"' not in open(os.path.join(PKG, "metrics", f)).read(), f


ROWS = 1_000_000
ITERS = 8  # two registrations of 4 iterations
K4_S, K7_S = 2.0**-8, 2.0**-6  # K4's device seconds in the window, K7's (exact sums)


def _trace(mix: dict) -> Trace:
    ops = [("void (anonymous namespace)::nn_grid_fold_kernel<0>(float const*, int)", 0.0, K4_S),
           ("void (anonymous namespace)::knn_grid_fold_kernel<1, 8>(int const*)", 0.5, 0.5 + K7_S)]
    return Trace(spans=[(0.0, 1.0)], device_ops=ops, host_ops=[],
                 registrations=[{"iters": 4}, {"iters": 4}], config={"rows": ROWS}, mix=mix)


def _read(name, mix):
    return run.read_metric(name, run.RunRecord(setup_s=1.0, window=run.Window(),
                                               trace=_trace(mix)))


@pytest.mark.parametrize("traffic", ["p2p", "p2p_trim", "p2pl"])
def test_the_roofline_readers_read_as_before(traffic):
    """Today's mixes read as the readers did while they took the payload
    from the reference's name and counted one kNN a registration."""
    mix = _mix(traffic)
    payload = 3 if mix["reference"] == "point_to_plane" else 0
    k4 = 100.0 * roofline.k4_bound_s(ROWS, ROWS, payload) / (K4_S / ITERS)
    assert _read("k4_roofline_pct", mix) == k4
    if "normal_k" in mix["kwargs"]:
        k = int(mix["kwargs"]["normal_k"]) + 1
        assert _read("k7_roofline_pct", mix) == 100.0 * roofline.k7_bound_s(ROWS, ROWS, k) / (K7_S / 2)


def test_a_gicp_like_mix_states_its_payload_and_searches():
    """A mix with the normals payload and two kNN searches a registration,
    under a reference name the readers have never seen: K4's bound counts
    three more columns a model row, K7's two searches."""
    mix = {k: v for k, v in _mix("p2pl").items() if k != "reference"}  # no reader looks
    mix.update(entry="icp_generalized", k7_searches=2)
    k4 = roofline.k4_bound_s(ROWS, ROWS, 3)
    assert k4 == (12 * 2 * ROWS + 4 * 3 * ROWS + 8 * ROWS) / roofline.HBM_BYTES_PER_S
    assert _read("k4_roofline_pct", mix) == 100.0 * k4 / (K4_S / ITERS)
    k7 = roofline.k7_bound_s(ROWS, ROWS, 17)
    assert _read("k7_roofline_pct", mix) == pytest.approx(2 * 100.0 * k7 / (K7_S / 2), rel=1e-15)
    one = dict(mix, k7_searches=1)
    assert _read("k7_roofline_pct", mix) == pytest.approx(2 * _read("k7_roofline_pct", one),
                                                          rel=1e-15)


def test_k4s_family_holds_its_near_tile_kernel():
    """``nn_grid_near_kernel`` runs inside K4's own call: its time is K4's."""
    near = "(anonymous namespace)::nn_grid_near_kernel(float const*, int, int)"
    tr = Trace(spans=[(0.0, 1.0)], device_ops=[(near, 0.0, 0.25)], host_ops=[],
               registrations=[{"iters": 1}], config={}, mix={})
    assert tr.family_seconds("K4") == 0.25 and tr.family_seconds("K7") == 0.0
