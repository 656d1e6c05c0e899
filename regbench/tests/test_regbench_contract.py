"""BENCHMARK.json and the result line keep to the benchmark's contract;
nothing the benchmark runs loads JAX or the JAX package; the reference
takes nothing of the program; a run with no card, or with no program
beside it, fails."""

from __future__ import annotations

import ast
import importlib
import inspect
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import SEED
from regbench import check, run

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
ROOT = os.path.dirname(PKG)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
P = inspect.Parameter
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_to_the_contract():
    spec = _spec()
    assert set(spec) == TOP_KEYS
    assert spec["paths"] == ["regbench"] and all(_line(w) for w in spec["command"])
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("regbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
    cells = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in configs and w["chips"] == 1
        for path in (f"traffic/{w['traffic']}.json", f"limits/{w['name']}.json"):
            assert os.path.exists(os.path.join(PKG, path)), path
        cells.add(w["name"])
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"]) and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(PKG, "metrics", f"{m['name']}.py")), m["name"]


@pytest.mark.parametrize("traced", [False, True])
def test_the_result_line_has_the_contract_keys(small_cell, card_path, traced):
    cell = small_cell("horse48k.p2p", sample=2)
    out = json.loads(json.dumps(run.run_cell(cell, SEED, 0.2, traced, "cpu")))
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if traced else [])
    assert [k for k in out if k in keys + ["checked"]] == keys + ["checked"]
    assert list(out)[-1] == "checked"
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if traced:
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {n for n, _ in (cell.per_layer if traced else cell.end_to_end)}
    assert set(out["metrics"]) <= names
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(out["checked"]) == set(check.compared(cell.limits)) >= {"points_gap"}
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1


def test_forbidden_modules_compare_top_level_names_whole(monkeypatch):
    for name in ("icp_tpu_torch", "icp_tpu_torch.engine", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys.modules.get(name, object()))
    found = run.forbidden_modules()
    assert not {"icp_tpu_torch", "jaxtyping", "flaxen"} & set(found)
    monkeypatch.setitem(sys.modules, "icp_tpu.engine.icp", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert {"icp_tpu", "jaxlib"} <= set(run.forbidden_modules())


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, dataclasses; from regbench import run; import icp_tpu_torch; "
            "import regbench.reference.icp, regbench.control, regbench.trace; "
            "cell = run.load_cell('horse1M.p2pl'); pts = cell.source.points[::128]; "
            "cell = dataclasses.replace(cell, source=cell.source._replace(points=pts), "
            "config=dict(cell.config, rows=len(pts)), "
            "limits=dict(cell.limits, sample=1)); run.run_cell(cell, 3, 0.05, True, 'cpu'); "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_takes_nothing_of_the_program():
    ref_dir = os.path.join(PKG, "reference")
    imported = set()
    for f in os.listdir(ref_dir):
        if f.endswith(".py"):
            mods = set(_imports(os.path.join(ref_dir, f)))
            tops = {m.partition(".")[0] for m in mods}
            assert tops <= {"__future__", "typing", "numpy", "scipy", "torch", "regbench"}, (f, tops)
            assert all(m.startswith("regbench.reference.") for m in mods
                       if m.partition(".")[0] == "regbench"), (f, mods)
            imported |= {m for m in mods if m.startswith("regbench.reference.")}
    code = ("import sys, importlib; from regbench import check; "
            "[importlib.import_module(f'regbench.reference.{n}') for n in check.references()]; "
            "print(sorted(m for m in sys.modules if m.partition('.')[0] in "
            "('icp_tpu_torch', 'icp_tpu', 'jax', 'jaxlib', 'flax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr[-2000:]
    # every module there is a reference, with the contract's ``answer``, or
    # the shared code that a reference imports
    refs = check.references()
    assert refs
    for f in os.listdir(ref_dir):
        name = f[:-3]
        if f.endswith(".py") and name != "__init__" and name not in refs:
            assert f"regbench.reference.{name}" in imported, f
    for name in refs:
        params = inspect.signature(importlib.import_module(f"regbench.reference.{name}").answer)
        kinds = [(p.name, p.kind) for p in params.parameters.values()]
        assert kinds == [("model", P.POSITIONAL_OR_KEYWORD), ("scene", P.POSITIONAL_OR_KEYWORD),
                         ("icp", P.POSITIONAL_OR_KEYWORD), ("kwargs", P.POSITIONAL_OR_KEYWORD),
                         ("precision", P.KEYWORD_ONLY), ("device", P.KEYWORD_ONLY)], name


def test_the_benchmark_imports_no_repository_tooling():
    banned = {"scripts", "chip_smoke", "bench_torch", "icp_tpu", "jax", "jaxlib", "flax"}
    for dirpath, _, files in os.walk(PKG):
        if os.path.basename(dirpath) == "tests":
            continue
        for f in files:
            if f.endswith(".py"):
                mods = set(_imports(os.path.join(dirpath, f)))
                assert not {m.partition(".")[0] for m in mods} & banned, f
                assert not any(m.startswith("icp_tpu_torch.bench") for m in mods), f


def test_a_run_without_a_card_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "horse48k.p2p", "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_a_checkout_without_the_program_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PKG, tmp_path / "regbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    out = subprocess.run([sys.executable, "-m", "regbench", "--workload", "horse48k.p2p",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
