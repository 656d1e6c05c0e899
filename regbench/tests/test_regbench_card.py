"""On the card: whole runs of the benchmark at the cells' own sizes, and
the control there.  Skipped without a card (run on one with
``python3 -m pytest regbench/tests -m cuda``)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import SEED
from regbench import check, control
from regbench.run import load_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _run(cell, trace):
    out = subprocess.run([sys.executable, "-m", "regbench", "--workload", cell, "--seed",
                          str(SEED), "--seconds", "1", "--trace", str(trace)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["horse48k.p2p", "horse1M.p2pl"])
def test_a_run_on_the_card_is_correct(card, cell):
    out = _run(cell, 0)
    assert out["correct"] and out["device"]["platform"] == "gpu", out["checked"]
    assert {"reg_per_s", "reg_p95_ms", "setup_s"} <= set(out["metrics"])


def test_a_traced_run_reads_every_metric_of_its_cell(card):
    out = _run("horse1M.p2pl", 1)
    assert out["correct"] and 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    names = {n for n, _ in load_cell("horse1M.p2pl").per_layer}
    assert set(out["metrics"]) == names


def test_the_control_fails_at_the_cells_size(card):
    cell = load_cell("horse48k.p2p")
    got = control.readings(cell, SEED, "cuda")
    assert check.fails(got, cell.limits), got
