"""A whole run with the timed path broken underneath comes out not
correct, once for each fault a registration can have; the same run,
sound, comes out correct.  The runs skip the look for a card and run the
card's path of the program on CPU tensors, at a few hundred rows."""

from __future__ import annotations

import pytest
import torch

import icp_tpu_torch
from conftest import CELLS, SEED
from regbench import run
from regbench.faults import FAULTS, install


def _run(cell):
    return run.run_cell(cell, SEED, 0.3, False, "cpu")


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(small_cell, card_path, name):
    out = _run(small_cell(name, sample=4))
    assert out["correct"], out["checked"]


def _faults_of_cells():
    """Each cell with each fault it can show: a reported error altered only
    where the cell compares ``err_gap``."""
    from regbench.check import load_limits

    return [(name, fault) for name in CELLS for fault in sorted(FAULTS)
            if fault != "altered_err" or load_limits(name).get("err_gap") is not None]


@pytest.mark.parametrize(("name", "fault"), _faults_of_cells())
def test_a_fault_makes_the_run_not_correct(small_cell, card_path, name, fault):
    cell = small_cell(name, sample=4)
    entry = cell.mix["entry"]
    undo = install(fault, entry)
    try:
        out = _run(cell)
    finally:
        undo()
    assert not out["correct"], out["checked"]


def test_a_failing_registration_makes_the_run_not_correct(small_cell, card_path, monkeypatch):
    cell = small_cell("horse48k.p2p", sample=2)
    real = icp_tpu_torch.icp

    def entry(model, scene, cfg, **kw):
        res = real(model, scene, cfg, **kw)
        return res._replace(err=torch.full_like(res.err, float("nan")))

    monkeypatch.setattr(icp_tpu_torch, "icp", entry)
    out = _run(cell)
    assert not out["correct"] and out["failed"] == out["attempted"] >= 1
