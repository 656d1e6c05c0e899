"""Structured run metrics (port of ``icp_tpu/utils/metrics.py``).

``run_with_metrics`` runs ``icp(trace=True)`` and builds a ``RunMetrics``
record with JAX's JSON fields: iterations, the last error, the wall time,
the per-iteration error trace, where it ran and the NN and solver it took.
``measure_ops=True`` adds the per-iteration time of the correspondence op
(K1 for ``pallas`` with the gather of the matches, K4 on the grid path, or
the plain NN method the run took) and of the alignment (the Horn sums and
the solve of the run's solver, K5 for ``qcp_fused``), measured once on the
run's clouds rather than inside the loop, which would cost a host wait an
iteration: the median of repeated calls after a warm-up, between CUDA
events on the card and by the host clock on the CPU, in microseconds.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import time
from typing import Optional

import torch

from icp_tpu_torch.utils.precision import in_full_float32


@dataclasses.dataclass
class RunMetrics:
    """Structured record for one registration run."""

    iters: int
    err: float
    wall_s: float
    errs: list  # per-iteration error trace (QUIRK-1 metric)
    backend: str  # the device type the run took: "cuda" or "cpu"
    nn_method: str
    solver: str
    correspondence_us: Optional[float] = None  # per-iteration op time
    alignment_us: Optional[float] = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


_WARMUP = 3  # calls before the timed ones
_REPS = 20  # timed calls


def op_time_us(fn, device: torch.device) -> float:
    """Median microseconds of a call of ``fn`` after ``_WARMUP`` calls:
    between CUDA events when ``fn`` runs on the card (``device``), else by
    the host clock."""
    cuda = device.type == "cuda"
    for _ in range(_WARMUP):
        fn()
    times = []
    for _ in range(_REPS):
        if cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) * 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(times)


def _op_times(model, scene, cfg, nn: str, solver: str) -> tuple:
    """(correspondence µs, alignment µs) of one iteration at these clouds:
    the NN op the run took, and the sums and solve on its matches."""
    from icp_tpu_torch.ops.alignment import alignment_from_stats, compute_alignment_stats
    from icp_tpu_torch.ops.distance import closest_point_indices

    m = model.to(torch.float32).contiguous()
    p = scene.to(torch.float32).contiguous()
    if nn == "grid":
        # the steady-state grid NN, as JAX's record: the scene kd-sorted,
        # bounds from every 4th model point
        from icp_tpu_torch.engine.grid import _prepare_scene
        from icp_tpu_torch.kernels.nn_grid import (
            bound_from_indices,
            build_model_grid,
            closest_point_indices_grid,
            initial_bound_indices,
        )

        scene_tile, model_tile, cap = cfg.resolved_grid_sizes(p.device)
        grid = build_model_grid(m, target_tile=model_tile)
        p, _, _, tn, _ = _prepare_scene(p, scene_tile)
        u = bound_from_indices(p, grid, initial_bound_indices(p, grid.model_orig, stride=4))

        def corr():
            return closest_point_indices_grid(p, grid, u, scene_tile=tn,
                                              max_candidates=cap)[1]
    else:
        def corr():
            return m[closest_point_indices(p, m, method=nn).to(torch.int64)]

    y = corr()
    corr_us = op_time_us(corr, p.device)
    align_us = op_time_us(lambda: alignment_from_stats(compute_alignment_stats(p, y),
                                                       solver=solver), p.device)
    return corr_us, align_us


@in_full_float32
def run_with_metrics(model, scene, config=None, *, measure_ops: bool = False, init=None,
                     device=None) -> tuple:
    """Run ``icp(trace=True)`` and build its ``RunMetrics``; returns
    ``(ICPTrace, RunMetrics)``.  Devices as in ``icp``."""
    from icp_tpu_torch.config import ICPConfig
    from icp_tpu_torch.engine.icp import as_points, icp

    cfg = config or ICPConfig()
    model = as_points(model, cfg.dtype, device)
    scene = as_points(scene, cfg.dtype, model.device)
    backend = model.device.type
    sync = torch.cuda.synchronize if backend == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    tr = icp(model, scene, cfg, trace=True, init=init)
    err = float(tr.result.err)
    sync()
    wall = time.perf_counter() - t0
    iters = int(tr.result.iters)
    nn = cfg.resolved_nn_method(backend, max(model.shape[0], scene.shape[0]))
    solver = cfg.resolved_solver(backend)
    corr_us = align_us = None
    if measure_ops:
        corr_us, align_us = _op_times(model, scene, cfg, nn, solver)
    rec = RunMetrics(iters=iters, err=err, wall_s=wall,
                     errs=[float(e) for e in tr.errs[:iters].tolist()], backend=backend,
                     nn_method=nn, solver=solver, correspondence_us=corr_us,
                     alignment_us=align_us)
    return tr, rec
