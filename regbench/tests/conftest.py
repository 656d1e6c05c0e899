"""Fixtures of the benchmark's own tests: cells cut to a few hundred rows
for the CPU, and the card's path of the program on CPU tensors."""

from __future__ import annotations

import dataclasses
import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# cells whose files the benchmark keeps while ``BENCHMARK.json`` leaves them
# out: (the cell of the same configuration it has, the traffic mix)
KEPT = {"horse48k.p2p_trim": ("horse48k.p2p", "p2p_trim")}
SEED = 2**31 + 1234567  # past 32 signed bits, as the benchmark's seeds may be


def _cells() -> tuple:
    """``BENCHMARK.json``'s cells, then the kept ones."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return tuple(w["name"] for w in json.load(f)["workloads"]) + tuple(KEPT)


CELLS = _cells()


@pytest.fixture
def small_cell():
    """``small_cell(name, step)``: the cell with every ``step``-th row of
    its base cloud, its configuration's ``rows`` cut to match (the 1M
    cells then sample the surface at the base's own density)."""
    def make(name: str, step: int = 64, sample: int | None = None):
        cell = kept_cell(name)
        pts = cell.source.points[::step]
        limits = dict(cell.limits) if sample is None else dict(cell.limits, sample=sample)
        return dataclasses.replace(cell, source=cell.source._replace(points=pts),
                                   config=dict(cell.config, rows=pts.shape[0]), limits=limits)

    return make


def kept_cell(name: str):
    """The cell ``name`` of ``BENCHMARK.json``, or one that ``KEPT`` names."""
    from regbench import check
    from regbench.run import _HERE, load_cell

    if name not in KEPT:
        return load_cell(name)
    like, mix = KEPT[name]
    with open(os.path.join(_HERE, "traffic", f"{mix}.json")) as f:
        return dataclasses.replace(load_cell(like), name=name, mix=json.load(f),
                                   limits=check.load_limits(name))


@pytest.fixture
def card_path(monkeypatch):
    """The program's "auto" resolved as on the card (the dense NN kernel's
    plain version, the float64 sums and the scalar step), with the fused
    iteration off: its expansion-form distance now and then takes the other
    of two near-equal neighbours, which moves a cloud of a few hundred rows
    far more than one of the cell's size, at which the limits were set."""
    from icp_tpu_torch.config import ICPConfig
    from icp_tpu_torch.engine import icp as engine

    monkeypatch.setattr(ICPConfig, "resolved_solver",
                        lambda self, backend: "qcp_fused" if self.solver == "auto" else self.solver)
    monkeypatch.setattr(ICPConfig, "resolved_nn_method",
                        lambda self, backend, n_points=None:
                        "pallas" if self.nn_method == "auto" else self.nn_method)
    monkeypatch.setattr(engine, "fused_path_available", lambda *a, **k: False)
