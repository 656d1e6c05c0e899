"""The benchmark of ``icp_tpu_torch``: back-to-back registrations on one
card, with their rate, their latency tails and the set-up, or (``--trace
1``) the per-layer metrics of a short traced window.

    python3 -m regbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run is one process, from the root of a checkout:

1. set-up: import the program, reach the card (the kernel library is
   built into the checkout on its first run), make the cell's data and run
   ``WARMUP`` registrations of the cell's shapes;
2. the window: one client in a closed loop.  Each request's clouds are
   made on the card from ``--seed`` and the request's index, off the
   clock; the clock runs from the call into the program's public entry to
   its result on the host, after ``torch.cuda.synchronize()``.  The window
   is the registrations' time together, and closes when it reaches
   ``--seconds``: every registration, completed or failed, and all of its
   time count, and nothing of the benchmark's own work does;
3. the check: a sample of the window's answers, drawn from the seed, is
   held against the plain reference (``check.py``) after the memory peak
   has been read;
4. the result: one JSON line, the last of standard output, with the
   numbers compared beside their limits also as the last lines of
   standard error.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``; its
configuration (``configs/``), its traffic mix (``traffic/``), its limits
(``limits/``), the reference its mix names (``reference/<name>.py``) and
each of its metrics (``metrics/<name>.py``) are files found by name.  With
no card, or fewer than the cell asks for, a run fails and prints no
result.  Nothing it runs may load JAX or the JAX package: a run that finds
them loaded fails.
"""

from __future__ import annotations

import argparse
from contextlib import nullcontext
import importlib.util
import json
import math
import os
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np

from regbench import check, trace
from regbench.traffic import Generator, Source, load_source, u64_seed

_HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(_HERE)
WARMUP = 3  # registrations of the cell's shapes before the window
TRACE_SECONDS = 2.0  # the longest traced window (whole registrations)
FORBIDDEN = ("jax", "jaxlib", "flax", "icp_tpu")  # top-level module names


@dataclass
class Cell:
    """Everything one cell's run reads, found by name."""

    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    source: Source
    end_to_end: list  # [(metric name, unit)]
    per_layer: list  # [(metric name, unit)]


@dataclass
class Window:
    latencies: list = field(default_factory=list)  # seconds, completed registrations
    seconds: float = 0.0
    attempted: int = 0
    failed: int = 0
    errors: list = field(default_factory=list)  # the first failures' messages


@dataclass
class RunRecord:
    """What the metric readers read."""

    setup_s: float
    window: Window
    trace: trace.Trace | None = None


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, spec_path: str = os.path.join(ROOT, "BENCHMARK.json")) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    spec = _load_json(spec_path)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; one of {', '.join(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = _load_json(os.path.join(ROOT, conf["file"]))
    mix = _load_json(os.path.join(_HERE, "traffic", f"{w['traffic']}.json"))
    refs = check.references()
    if mix.get("reference") not in refs:
        raise SystemExit(f"traffic {w['traffic']!r} names the reference {mix.get('reference')!r}; "
                         f"one of {', '.join(refs)} (reference/<name>.py with an answer)")

    def reported(m, e2e_here=None):
        if "workloads" in m:
            return name in m["workloads"]
        return e2e_here is None or m["moves"] in e2e_here

    e2e = [(m["name"], m["unit"]) for m in spec["end_to_end"] if reported(m)]
    layer = [(m["name"], m["unit"]) for m in spec["per_layer"]
             if reported(m, {n for n, _ in e2e})]
    return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix,
                limits=check.load_limits(name),
                source=load_source(config),
                end_to_end=e2e, per_layer=layer)


def read_metric(name: str, record: RunRecord):
    """The value of metric ``name`` from its reader ``metrics/<name>.py``,
    or None where the reader found nothing to read."""
    path = os.path.join(_HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"regbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def _entry_and_config(cell: Cell):
    import torch

    import icp_tpu_torch

    fields = dict(cell.config["icp"], **cell.mix.get("icp", {}))
    cfg = icp_tpu_torch.ICPConfig(dtype=getattr(torch, cell.config["dtype"]), **fields)
    return getattr(icp_tpu_torch, cell.mix["entry"]), cfg, dict(cell.mix.get("kwargs", {}))


def _finite(result) -> bool:
    import torch

    tr = result.transform
    vals = torch.cat([tr.s.reshape(1), tr.R.reshape(-1), tr.t.reshape(-1),
                      result.err.reshape(1)]).double()
    return bool(torch.isfinite(vals).all())


def drive(gen: Generator, entry, cfg, kwargs, seconds: float, sample: check.Sample, sync,
          first: int = 0, spans: bool = False) -> tuple:
    """Back-to-back registrations of requests ``first``, ``first + 1``, ...
    until the time spent in them reaches ``seconds`` (one at least);
    returns (Window, [{"iters"}] of the completed registrations)."""
    from torch.profiler import record_function

    win, done = Window(), []
    i = first
    while win.seconds < seconds or not win.attempted:
        req = gen.make(i)
        sync()
        win.attempted += 1
        c0 = time.perf_counter()
        try:
            with record_function(trace.REGISTRATION_SPAN) if spans else nullcontext():
                res = entry(req.model, req.scene, cfg, **kwargs)
                iters, err = int(res.iters), float(res.err)
                sync()
            c1 = time.perf_counter()
            ok = math.isfinite(err) and _finite(res)
        except Exception as exc:  # a failed registration is counted, not fatal
            c1, ok = time.perf_counter(), False
            if len(win.errors) < 3:
                win.errors.append(f"request {i}: {traceback.format_exception_only(exc)[-1].strip()}")
        win.seconds += c1 - c0
        if ok:
            win.latencies.append(c1 - c0)
            done.append({"iters": iters})
            sample.offer(i, res)
        else:
            win.failed += 1
        i += 1
    return win, done


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
             t0: float | None = None) -> dict:
    """One run of ``cell`` on ``device``; returns the result line's object."""
    t0 = time.perf_counter() if t0 is None else t0
    import torch

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def phase(name):  # where the set-up's time goes, on standard error
        sync()
        print(f"setup {name} {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)

    entry, cfg, kwargs = _entry_and_config(cell)
    phase("imports")
    gen = Generator(cell.config, cell.mix, seed, dev, cell.source)
    phase("device and data")
    for w in range(WARMUP):  # requests -1, -2, ...: none of the window's
        drive(gen, entry, cfg, kwargs, 0.0, check.Sample(1, np.random.default_rng(0)), sync,
              first=-1 - w)
        phase(f"warm-up registration {w + 1}")
    setup_s = time.perf_counter() - t0

    sample = check.Sample(int(cell.limits["sample"]), np.random.default_rng(u64_seed(seed, 0x636b)))
    record = RunRecord(setup_s=setup_s, window=Window())
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            record.window, done = drive(gen, entry, cfg, kwargs, min(seconds, TRACE_SECONDS),
                                        sample, sync, spans=True)
        record.trace = trace.from_profiler(prof, done, cell.config, cell.mix)
    else:
        record.window, _ = drive(gen, entry, cfg, kwargs, seconds, sample, sync)
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0

    metrics = {}
    for name, unit in (cell.per_layer if traced else cell.end_to_end):
        value = read_metric(name, record)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": peak}
    if record.trace is not None:
        device_info.update(busy_s=record.trace.busy_s, window_s=record.trace.window_s)

    outputs = sample.outputs()
    c0 = time.perf_counter()
    checked, readings = check.compare(outputs, gen.make, cell.config, cell.mix, cell.limits, dev)
    check_s = time.perf_counter() - c0
    win = record.window
    correct = (win.failed == 0 and bool(outputs)
               and all(c["value"] <= c["limit"] for c in checked.values()))
    out = {"correct": correct, "attempted": win.attempted, "failed": win.failed,
           "metrics": metrics, "device": device_info}
    if record.trace is not None:
        out["breakdown"] = record.trace.breakdown()
    out["notes"] = {"registrations": len(win.latencies), "window_s": win.seconds,
                    "checked_requests": [o.index for o in outputs],
                    "checked_iters": [o.iters for o in outputs], "check_s": check_s,
                    "readings": readings,
                    "errors": win.errors}
    out["checked"] = checked
    return out


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None, t0: float | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m regbench", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"regbench: {args.workload} needs {cell.chips} CUDA card(s), found {have}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    bad = forbidden_modules()
    if bad:
        print(f"regbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["checked"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
