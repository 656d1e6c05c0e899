"""How ``correct`` is decided: the program's answers to a sample of the
window's registrations against the plain reference's, from the same
inputs made again from the seed.

The reference is the one the cell's traffic mix names: ``"reference":
"<name>"`` is the module ``reference/<name>.py``, imported by that name
after the window (its SciPy import is no part of the set-up) and called
as ``answer(model, scene, icp, kwargs, *, precision, device)``: the two
clouds as float64 arrays, the configuration's ``icp`` merged with the
mix's, the mix's ``kwargs``, ``precision`` ``"float64"`` for the reference
or ``"tf32"`` for the control (``control.py``), and the device of the
exact search.  It returns a ``reference.icp.Answer``, imports only NumPy,
SciPy, torch and ``regbench.reference.*``, and takes nothing that the
program made (``reference/__init__.py``).  Nothing here names a
reference: a new one is a new file.

The numbers compared, each the largest over the sample, each held to the
cell's limit (``limits/<cell>.json``):

* ``points_gap``: the widest distance between a point of the program's
  moved scene (``result.points``) and the reference's, over the model's
  diagonal.  An iteration too many or too few, a wrong match, step or
  apply shows here.
* ``transform_gap``: the same for the scene moved by the program's
  returned similarity (``result.transform``, applied here in float64).
* ``err_gap``: the program's last reported error against the
  reference's, as a share of the reference's.

The loop stops after the first iteration whose error is under the
threshold.  Where the reference's error at that decision lies within
``STOP_BAND`` of the threshold, float32 and float64 may decide it either
way, as two equally near points tie: a program that stopped one iteration
earlier or later is held to the reference run for its own count
(``reference_for``).  Any other difference in the count moves the points
by a whole step, which ``points_gap`` sees.

A number whose limit is ``null`` in the cell's file is read but not
compared: it has no upper reading there (see ``PERF.md``).  A
registration that raised or returned a non-finite error or transform
counts as failed, and a run with a failure is not correct.
"""

from __future__ import annotations

import ast
import importlib
import json
import os
from typing import NamedTuple

import numpy as np

NUMBERS = ("points_gap", "transform_gap", "err_gap")
STOP_BAND = 0.01  # relative to the threshold: a stop decided within it is a tie
_HERE = os.path.dirname(os.path.abspath(__file__))


class Output(NamedTuple):
    """One registration's answer as the program gave it, on the host."""

    index: int
    points: np.ndarray
    s: float
    R: np.ndarray
    t: np.ndarray
    err: float
    iters: int


def load_limits(cell: str) -> dict:
    with open(os.path.join(_HERE, "limits", f"{cell}.json")) as f:
        return json.load(f)


def compared(limits: dict) -> tuple:
    """The numbers that ``limits`` holds to a limit."""
    return tuple(k for k in NUMBERS if limits.get(k) is not None)


def fails(readings: dict, limits: dict) -> bool:
    """Whether ``readings`` fail any of the limits."""
    return any(readings[k] > limits[k] for k in compared(limits))


def output_of(index: int, result) -> Output:
    """An ``Output`` from the program's ``ICPResult``."""
    tr = result.transform
    return Output(index=index, points=result.points.double().cpu().numpy(),
                  s=float(tr.s), R=tr.R.double().cpu().numpy(), t=tr.t.double().cpu().numpy(),
                  err=float(result.err), iters=int(result.iters))


def references() -> list:
    """The references a mix can name: the modules of ``reference/`` that
    define ``answer`` at their top level, read from their source (nothing
    is imported)."""
    ref_dir = os.path.join(_HERE, "reference")
    names = []
    for f in sorted(os.listdir(ref_dir)):
        if f.endswith(".py"):
            with open(os.path.join(ref_dir, f)) as src:
                tree = ast.parse(src.read())
            if any(isinstance(node, ast.FunctionDef) and node.name == "answer"
                   for node in tree.body):
                names.append(f[:-3])
    return names


def reference_answer(config: dict, mix: dict, model: np.ndarray, scene: np.ndarray,
                     precision: str = "float64", device: str = "cpu"):
    """The answer (``reference.icp.Answer``) of the reference that ``mix``
    names to the registration of ``scene`` onto ``model`` as the cell
    states it."""
    reference = importlib.import_module(f"regbench.reference.{mix['reference']}")
    icp = dict(config["icp"], **mix.get("icp", {}))
    return reference.answer(model, scene, icp, dict(mix.get("kwargs", {})),
                            precision=precision, device=device)


def reference_for(out, ref, config: dict, mix: dict, model: np.ndarray, scene: np.ndarray,
                  device: str = "cpu"):
    """The reference answer to hold ``out`` to: ``ref`` itself, or, where
    the two counts differ by one and the reference's error at the stop
    that the program decided otherwise lies within ``STOP_BAND`` of the
    threshold, the reference run for exactly ``out.iters`` iterations."""
    if abs(out.iters - ref.iters) != 1:
        return ref
    tau = float(dict(config["icp"], **mix.get("icp", {}))["threshold"])
    fixed = dict(config, icp=dict(config["icp"], threshold=0.0, max_iter=int(out.iters)))
    mine = reference_answer(fixed, mix, model, scene, device=device)
    # the reference's error where the program stopped and it went on, or
    # where it stopped and the program went on
    err = mine.err if out.iters < ref.iters else ref.err
    return mine if abs(err - tau) <= STOP_BAND * tau else ref


def gaps(out, ref, scene: np.ndarray, diag: float) -> dict:
    """The numbers compared for one registration (``out``: an ``Output``
    or another ``Answer``)."""
    moved = out.s * scene @ np.asarray(out.R).T + np.asarray(out.t)

    def widest(a):
        return float(np.sqrt(((a - ref.points) ** 2).sum(1)).max()) / diag

    err_gap = abs(out.err - ref.err) / abs(ref.err) if ref.err != 0 else abs(out.err)
    gap = {"points_gap": widest(out.points), "transform_gap": widest(moved),
           "err_gap": float(err_gap)}
    return {k: (float("inf") if not np.isfinite(v) else v) for k, v in gap.items()}


def compare(outputs: list, make_request, config: dict, mix: dict, limits: dict,
            device: str = "cpu") -> tuple:
    """The largest of each number over ``outputs`` (the program's sampled
    answers), each request made again by ``make_request(index)``; returns
    ({name: {"value", "limit"}} of the compared numbers, {name: value} of
    all)."""
    worst = {k: 0.0 for k in NUMBERS}
    for out in outputs:
        req = make_request(out.index)
        model = req.model.double().cpu().numpy()
        scene = req.scene.double().cpu().numpy()
        diag = float(np.linalg.norm(model.max(0) - model.min(0)))
        ref = reference_answer(config, mix, model, scene, device=device)
        ref = reference_for(out, ref, config, mix, model, scene, device)
        for k, v in gaps(out, ref, scene, diag).items():
            worst[k] = max(worst[k], v)
    return {k: {"value": worst[k], "limit": float(limits[k])} for k in compared(limits)}, worst


class Sample:
    """A uniform sample of ``size`` of the window's answers, drawn from the
    seed as they come (reservoir sampling), and the answer with the most
    iterations beside it."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng = size, rng
        self.kept: list = []
        self.seen = 0
        self.longest = None  # (iters, index, result)

    def offer(self, index: int, result) -> None:
        """Consider the program's ``result`` of request ``index``; a kept
        result is cloned, so later calls cannot change it."""
        iters = int(result.iters)
        slot = None
        if self.seen < self.size:
            slot = len(self.kept)
            self.kept.append(None)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            slot = j if j < self.size else None
        self.seen += 1
        longest = self.longest is None or iters > self.longest[0]
        if slot is None and not longest:
            return
        kept = (index, _clone(result))
        if slot is not None:
            self.kept[slot] = kept
        if longest:
            self.longest = (iters, *kept)

    def outputs(self) -> list:
        chosen = {i: r for i, r in self.kept}
        if self.longest is not None:
            chosen.setdefault(self.longest[1], self.longest[2])
        return [output_of(i, chosen[i]) for i in sorted(chosen)]


def _clone(result):
    return type(result)(*(type(v)(*(x.clone() for x in v)) if isinstance(v, tuple)
                          else v.clone() for v in result))
