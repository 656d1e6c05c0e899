"""Benchmark harness: the reference's op matrix on the card (port of
``icp_tpu/bench/harness.py``).

Reference counterpart: ``src/bench.cc:391-447`` (Google Benchmark over
{CPU, GPU-naive, GPU-opti} x {full loop, closest, find_alignment, centroid,
err_compute, err_compute_alignment} on the cow pair).  Each op runs
through the port's public functions on the card (``device="cpu"`` on the
CPU, the plain versions), with the JAX harness's rows, names and keys.  Two
timing protocols:

  * ``amortized_op_time``: the op chained ``n`` times on the device, each
    call folding the previous output into its inputs, timed between two
    CUDA events at two ``n`` and differenced; on the card each op row
    carries ``carry_us``, the same chain around a null op, the part of
    ``time_us`` that is the chain's own;
  * ``wall_time``: best-of-N host time between two synchronisations, what
    a caller sees per call; ``differenced`` times a run of ``k`` units at
    two ``k`` (interleaved) and differences them: ``loop_per_iter`` is it
    for the fixed-iteration loop on one path (``bench_torch.py`` times the
    headline with it).

One JSON object a row on stdout, progress on stderr (the reference's
stdout-metrics / stderr-logs split).  ``main`` is ``icp-bench-torch``::

    python -m icp_tpu_torch.bench.harness [--workload cow|horse] [--only ROW ...]
                                          [--iters N] [--device cuda|cpu]

What each row launches on the card: ``closest_pallas`` K1; ``closest_grid``
K4 (its K1 seed before the timed calls); ``closest_bf16`` K9;
``find_alignment`` K5; ``full_loop`` K3 once an iteration (models up to
``MAX_FUSED_MODEL`` rows; above it the pipeline); ``full_loop_pipeline``
K1 and K2 once an iteration; ``full_loop_grid`` K1's seed, then K4 and K2
an iteration; ``global_register`` K6; ``batched_bucketed`` K1 and K2 once an
iteration for the four pairs; ``full_loop_sharded`` K1 a ring hop and K5 an
iteration.  ``closest_bcast``, ``closest_matmul``, ``compute_centroid``
and the ``err_compute`` rows are torch ops.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch


_EPS = 1e-20  # the carry's weight where it enters an op's inputs


def _progress(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_pair(workload: str = "cow"):
    from icp_tpu_torch.io.csv import load_matrix

    d = os.path.join(repo_root(), "data")
    ref = load_matrix(os.path.join(d, f"{workload}_ref.txt"))
    tr1 = load_matrix(os.path.join(d, f"{workload}_tr1.txt"))
    return ref, tr1


def load_cow():
    return load_pair("cow")


def card_identity():
    """(name, power limit in W) of the first card as ``nvidia-smi
    --query-gpu=name,power.limit`` prints them; (None, None) where the
    command is absent or fails."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None, None
    if not out:
        return None, None
    name, _, limit = out[0].rpartition(",")
    try:
        return name.strip(), float(limit.strip().split()[0])
    except (ValueError, IndexError):
        return name.strip() or None, None


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _device_of(args) -> torch.device:
    return next((a.device for a in args if isinstance(a, torch.Tensor)), torch.device("cpu"))


def _first_leaf(out) -> torch.Tensor:
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out


def _timed(run, device: torch.device) -> float:
    """Seconds of ``run()``: between two CUDA events on the card, by the
    host clock on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


def amortized_op_time(fn, args, n_small: int = 20, n_big: int = 520,
                      reps: int = 3, inner: int = 1):
    """Seconds a call of ``fn(*args, carry)``: ``n`` calls chained on the
    device, timed at ``n_small`` and ``n_big`` (best of ``reps`` each) and
    differenced.

    ``fn`` must fold its carry (a 0-d float32 tensor on the device) into its
    inputs (``torch.add(p, c, alpha=1e-20)``); the next carry adds the sum
    of the first leaf of its output, scaled by 1e-12, so every call waits
    for the one before.  The carry stays a device scalar: nothing in the
    chain reads it to the host or synchronises.  ``inner``: chained calls a
    step, to lift ops of a few microseconds above the timer's noise.

    Unlike JAX's version (one compiled scan on the device), each call here
    is launched from the host, so where an op's launches take longer than
    its kernels the figure includes the host's gaps between them: it is
    what the card takes a call when driven call by call, not its busy time.
    The carry's own three launches a call are part of it: ``null_op_time``
    times them alone.
    """
    device = _device_of(args)

    def chain(n: int) -> torch.Tensor:
        c = torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(n):
            for _k in range(inner):
                leaf = _first_leaf(fn(*args, c))
                c = torch.add(c, leaf.sum(dtype=torch.float32), alpha=1e-12)
        return c

    float(chain(n_small))  # warm: kernels built, allocator primed
    t = {n: min(_timed(lambda: chain(n), device) for _ in range(reps))
         for n in (n_small, n_big)}
    return (t[n_big] - t[n_small]) / ((n_big - n_small) * inner)


def null_op_time(args, **kw) -> float:
    """``amortized_op_time`` of an op that only takes the carry in (the
    scene ``args[1]`` plus it): the chain's own seconds a call, to read
    beside (or take off) an op row's."""
    return amortized_op_time(lambda m, p, c: torch.add(p, c, alpha=_EPS), args, **kw)


def wall_time(fn, reps: int = 5):
    """Best-of-``reps`` host seconds of ``fn()``, the card synchronised
    before and after each call (one warm-up call first)."""
    fn()
    best = float("inf")
    for _ in range(reps):
        best = min(best, _wall(fn))
    return best


def _wall(fn) -> float:
    _sync()
    t0 = time.perf_counter()
    fn()
    _sync()
    return time.perf_counter() - t0


def differenced(run, small: int, big: int, reps: int = 5):
    """(seconds a unit, seconds of ``run(small)``): ``run(k)`` does ``k``
    units of work (iterations); it is timed as ``wall_time`` times, at
    ``small`` and ``big`` in turn (one warm-up of each, then ``reps``
    rounds, so both see the same host), best of each, and differenced over
    ``big - small``."""
    best = {small: math.inf, big: math.inf}
    for k in (small, big):
        run(k)
    for _ in range(reps):
        for k in (small, big):
            best[k] = min(best[k], _wall(lambda: run(k)))
    return (best[big] - best[small]) / (big - small), best[small]


LOOP_PATHS = ("fused", "pipeline", "grid")


def loop_per_iter(ref: torch.Tensor, tr1: torch.Tensor, path: str, small: int = 20,
                  big: int = 520, reps: int = 5):
    """(seconds an iteration, seconds of the ``small`` run) of
    ``icp_fixed_iters(ref, tr1)`` (``ref`` the model, ``tr1`` the scene) on
    ``path``, by ``differenced``.  On the card (``nn_method="pallas"``,
    ``solver="qcp_fused"``): ``"fused"`` the dense loop as dispatched (K3
    once an iteration up to ``MAX_FUSED_MODEL`` model rows, above it the
    pipeline), ``"pipeline"`` the same under ``fused_path_disabled`` (K1,
    float64 sums, K2), ``"grid"`` ``nn_method="grid"`` (K1's seed, then K4
    and K2).  On the CPU the dense paths run ``bcast``/``eigh``, the plain
    versions."""
    from icp_tpu_torch.engine.icp import icp_fixed_iters

    if path not in LOOP_PATHS:
        raise ValueError(f"loop_per_iter: path must be one of {LOOP_PATHS}, got {path!r}")
    on_card = ref.device.type == "cuda"
    method = "grid" if path == "grid" else ("pallas" if on_card else "bcast")
    solver = "qcp_fused" if on_card else "eigh"

    def run(k):
        float(icp_fixed_iters(ref, tr1, n_iters=k, solver=solver, nn_method=method).err)

    with fused_path_disabled() if path == "pipeline" else contextlib.nullcontext():
        return differenced(run, small, big, reps)


@contextlib.contextmanager
def fused_path_disabled():
    """Within the body the dense loop takes the pipeline (K1, float64 sums,
    K2) where it would take the fused kernel K3.  ``engine/icp._icp_dense``
    reads ``fused_path_available`` from its own module's namespace (bound at
    import), so that is the name replaced; it is put back on exit."""
    import icp_tpu_torch.engine.icp as engine

    orig = engine.fused_path_available
    engine.fused_path_available = lambda *a, **k: False
    try:
        yield
    finally:
        engine.fused_path_available = orig



def _numpy_icp(ref: np.ndarray, scene: np.ndarray, n_iters: int):
    """``n_iters`` sequential host-NumPy ICP iterations (brute-force chunked
    NN + Horn quaternion solve + apply/error — the same per-iteration op
    sequence as the device engines, f64 like the reference).  Returns
    ``(wall_seconds, final_points)`` — the dual-engine baseline row."""
    m = np.asarray(ref, np.float64)
    p = np.asarray(scene, np.float64).copy()
    mn = np.sum(m * m, axis=1)
    chunk = max(1, int(2e7 // max(len(m), 1)))  # cap the distance block

    def nn(p):
        out = np.empty(len(p), np.int64)
        for i in range(0, len(p), chunk):
            blk = p[i:i + chunk]
            d = mn[None, :] - 2.0 * (blk @ m.T)
            out[i:i + chunk] = np.argmin(d, axis=1)
        return out

    def horn(p, y):
        mu_p, mu_y = p.mean(0), y.mean(0)
        pc, yc = p - mu_p, y - mu_y
        S = pc.T @ yc
        tr = np.trace(S)
        delta = np.array([S[1, 2] - S[2, 1], S[2, 0] - S[0, 2],
                          S[0, 1] - S[1, 0]])
        N = np.empty((4, 4))
        N[0, 0] = tr
        N[0, 1:] = N[1:, 0] = delta
        N[1:, 1:] = S + S.T - tr * np.eye(3)
        w, V = np.linalg.eigh(N)
        q = V[:, np.argmax(w)]
        a, b, c, d = q
        R = np.array([
            [a*a + b*b - c*c - d*d, 2*(b*c - a*d), 2*(b*d + a*c)],
            [2*(b*c + a*d), a*a - b*b + c*c - d*d, 2*(c*d - a*b)],
            [2*(b*d - a*c), 2*(c*d + a*b), a*a - b*b - c*c + d*d],
        ])
        s = np.sqrt(np.sum(yc * yc) / max(np.sum(pc * pc), 1e-30))
        t = mu_y - s * (R @ mu_p)
        return s, R, t

    t0 = time.perf_counter()
    for _ in range(n_iters):
        y = m[nn(p)]
        s, R, t = horn(p, y)
        p = s * (p @ R.T) + t
        _ = float(np.sum((y - p) ** 2))  # the error pass
    return time.perf_counter() - t0, p


def _grid_op(ref: torch.Tensor):
    """The ``closest_grid`` row's op: the steady-state grid NN (K4) of the
    kd-sorted, padded scene against ``ref`` with the previous iteration's
    bounds, what every iteration after the first sees (the scene has
    converged onto the model).  K1's seed of the bounds runs here, outside
    the timed calls."""
    from icp_tpu_torch.engine.grid import _prepare_scene
    from icp_tpu_torch.kernels.nn_grid import (
        bound_from_indices,
        build_model_grid,
        closest_point_indices_grid,
    )
    from icp_tpu_torch.ops.distance import closest_point_indices

    grid = build_model_grid(ref)
    p_kd, _, _, tn, _ = _prepare_scene(ref, 256)
    prev = closest_point_indices(p_kd, ref, method="pallas")
    u_prev = bound_from_indices(p_kd, grid, prev.to(torch.int64))

    def nn_grid(m, p, c):
        return closest_point_indices_grid(torch.add(p_kd, c, alpha=_EPS), grid,
                                          torch.add(u_prev, c, alpha=_EPS),
                                          scene_tile=tn)[0]

    return nn_grid


def _unresolved(benchmark: str, per: float) -> dict:
    """A row whose two timings differ by less than their noise: reported as
    such, never as a time."""
    _progress(f"{benchmark}: UNRESOLVED (diff {per * 1e6:.3f} us)")
    return dict(benchmark=benchmark, unresolved=True, raw_diff_us=per * 1e6)


def benchmark_matrix(n_iters: int = 20, include=None, workload: str = "cow", device=None):
    """Run the op-level matrix on ``device`` (the card unless ``"cpu"``);
    returns a list of result dicts."""
    from icp_tpu_torch.bench.roofline import chip_spec, iteration_mfu_pct, mfu_fields
    from icp_tpu_torch.engine.icp import target_device
    from icp_tpu_torch.ops.alignment import alignment_from_stats, compute_alignment_stats
    from icp_tpu_torch.ops.distance import (
        closest_point_indices,
        closest_point_indices_bcast,
        closest_point_indices_matmul,
    )
    from icp_tpu_torch.ops.transform import apply_and_error, identity_similarity
    from icp_tpu_torch.utils.precision import full_float32

    dev = target_device(None, device)
    on_card = dev.type == "cuda"
    nn_method = "pallas" if on_card else "bcast"
    solver = "qcp_fused" if on_card else "eigh"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    ref_np, tr1_np = load_pair(workload)
    ref = torch.as_tensor(ref_np, dtype=torch.float32, device=dev)
    tr1 = torch.as_tensor(tr1_np, dtype=torch.float32, device=dev)

    def nn_bcast(m, p, c):
        return closest_point_indices_bcast(torch.add(p, c, alpha=_EPS), m)

    def nn_matmul(m, p, c):
        return closest_point_indices_matmul(torch.add(p, c, alpha=_EPS), m)

    def nn_pallas(m, p, c):
        return closest_point_indices(torch.add(p, c, alpha=_EPS), m, method="pallas")

    def find_alignment(m, p, c):
        pp = torch.add(p, c, alpha=_EPS)
        sim = alignment_from_stats(compute_alignment_stats(pp, m),
                                   solver=solver)
        # R first: the chain folds the FIRST leaf into the carry, and R is
        # the solve's output (s needs only the norm sums)
        return sim.R, sim.s, sim.t

    def centroid(m, p, c):
        return torch.mean(torch.add(p, c, alpha=_EPS), dim=0)

    def err_compute(m, p, c):
        sim = identity_similarity(torch.float32, dev)
        return apply_and_error(torch.add(p, c, alpha=_EPS), m, sim)[1]

    def err_compute_alignment(m, p, c):
        # the reference's NON-mutating residual variant (src/cpu.cc:93-103,
        # its own benchmark at src/bench.cc:427-431): the same residual, the
        # transformed cloud discarded
        sim = identity_similarity(torch.float32, dev)
        return apply_and_error(torch.add(p, c, alpha=_EPS), m, sim)[1], m

    ops = {
        "closest_bcast": nn_bcast,
        "closest_matmul": nn_matmul,
        "find_alignment": find_alignment,
        "compute_centroid": centroid,
        "err_compute": err_compute,
        "err_compute_alignment": err_compute_alignment,
    }
    # The torch NN rows materialize a block of the N x M matrix at a time,
    # at horse ~2.35 G pairs a call: capped as JAX caps its XLA rows.
    if ref.shape[0] * tr1.shape[0] > 4e8:
        for name in ("closest_bcast", "closest_matmul"):
            ops.pop(name)
            _progress(f"op {name}: skipped "
                      f"({ref.shape[0] * tr1.shape[0] * 4 / 1e9:.1f} GB of distances)")
    if on_card:
        from icp_tpu_torch.kernels.nn_bf16 import closest_point_indices_bf16

        def nn_bf16(m, p, c):
            # the approximate bf16 prefilter K9 with its exact recheck
            return closest_point_indices_bf16(torch.add(p, c, alpha=_EPS), m)

        ops["closest_pallas"] = nn_pallas
        if not include or "closest_grid" in include:
            ops["closest_grid"] = _grid_op(ref)
        ops["closest_bf16"] = nn_bf16

    spec = chip_spec(torch.cuda.get_device_name(dev)) if on_card else None
    n, m = ref.shape[0], tr1.shape[0]
    n_pairs = n * m  # correspondence problem size
    fbytes = 4  # float32
    # bytes a call (inputs read once, outputs written once) for hbm_util_pct
    op_bytes = {
        "compute_centroid": n * 3 * fbytes,
        "err_compute": 2 * n * 3 * fbytes,
        "err_compute_alignment": 2 * n * 3 * fbytes,
        "find_alignment": 2 * n * 3 * fbytes,
    }
    results = []
    carry = None  # the chain's own time a call, on the card: timed once
    with full_float32():
        for name, fn in ops.items():
            if include and name not in include:
                continue
            if on_card and carry is None:
                carry = null_op_time((ref, tr1))
                _progress(f"the chain's carry: {carry*1e6:.2f} us a call")
            _progress(f"op {name} ...")
            # JAX chains 16 calls a step over 2,020 steps for its sub-microsecond
            # rows, to rise above a remote sync of ~35 ms; CUDA events resolve a
            # microsecond and a call here is several launches (tens of us), so
            # every row takes the defaults
            per = amortized_op_time(fn, (ref, tr1))
            if per <= 0:
                results.append(_unresolved(name, per))
                continue
            row = dict(benchmark=name, time_us=per * 1e6, rate_per_s=1.0 / per)
            if carry is not None:
                row["carry_us"] = carry * 1e6
            pairs_rate = None
            if name.startswith("closest"):
                # exhaustive-NN throughput (the grid row exceeds the dense
                # bound: that is what pruning is for, so it has no mfu_pct)
                pairs_rate = n_pairs / per
                row["point_pairs_per_s"] = pairs_rate
            row.update(mfu_fields(spec, name, pairs_rate, op_bytes.get(name), per))
            results.append(row)
            _progress(f"op {name}: {per*1e6:.2f} us")

    # The full fixed-iteration loop (the headline) on each path, differenced
    # over 500 iterations of host wall time.
    loops = [("full_loop", "fused", "full_loop_per_iter")]
    if on_card:
        loops += [("full_loop_pipeline", "pipeline", "full_loop_pipeline_per_iter"),
                  ("full_loop_grid", "grid", "full_loop_grid_per_iter")]
    for key, path, name in loops:
        if include and key not in include:
            continue
        _progress(f"full loop ({path}) ...")
        per_iter, t_small = loop_per_iter(ref, tr1, path, n_iters, n_iters + 500)
        if per_iter <= 0:
            results.append(_unresolved(name, per_iter))
            continue
        row = dict(benchmark=name, time_us=per_iter * 1e6, rate_per_s=1.0 / per_iter,
                   point_pairs_per_s=n_pairs / per_iter)
        if path != "pipeline":
            row["wall_20_iters_ms"] = t_small * 1e3
        if path == "fused":
            # ``mfu_pct``: the NN fold's bound alone; ``mfu_iter_pct``: K3's
            # whole-iteration bound (the fold and the solve).  tr1 is the
            # SCENE (m rows) and ref the MODEL (n rows).  A grid iteration
            # folds a fraction of the pairs by design: never graded so.
            row.update(mfu_fields(spec, "closest_fused", n_pairs / per_iter, None, per_iter))
            if spec is not None:
                row["mfu_iter_pct"] = iteration_mfu_pct(spec, m, n, per_iter)
        results.append(row)
        _progress(f"full loop ({path}): {per_iter*1e6:.1f} us/iter ({1/per_iter:.0f} iter/s; "
                  f"{n_iters}-iter wall {t_small*1e3:.1f} ms)")

    if not include or "full_loop_numpy" in include:
        # the dual-engine row (the reference's bench links its CPU and GPU
        # engines into one binary, src/bench.cc:391-447): the same
        # per-iteration work in host NumPy
        _progress("full loop (numpy host engine) ...")
        t_np, _ = _numpy_icp(ref_np, tr1_np, n_iters)
        per_iter = t_np / n_iters
        results.append(dict(
            benchmark="full_loop_numpy_per_iter",
            time_us=per_iter * 1e6,
            rate_per_s=1.0 / per_iter,
            point_pairs_per_s=n_pairs / per_iter,
            # host BLAS on a shared host: a context row, not a gated one
            gate=False,
        ))
        _progress(f"full loop (numpy): {per_iter*1e6:.0f} us/iter "
                  f"({1/per_iter:.1f} iter/s host-side)")

    if not include or "global_register" in include:
        # FPFH + spectral filter + RANSAC (engine/global_reg.py) on a
        # 150-degree pose offset of the workload cloud: the whole pipeline's
        # wall, what a user pays once a pair
        from icp_tpu_torch.engine.global_reg import global_register

        ang = 2.618  # 150 degrees
        R_g = np.array([[np.cos(ang), -np.sin(ang), 0.0],
                        [np.sin(ang), np.cos(ang), 0.0],
                        [0.0, 0.0, 1.0]], np.float32)
        scene_rot = np.asarray(ref_np, np.float32) @ R_g.T + np.array(
            [1.0, -2.0, 0.5], np.float32)

        def run_greg():
            res = global_register(ref_np, scene_rot, seed=0, device=dev)
            float(res.inlier_fraction)

        _progress("global_register ...")
        t_g = wall_time(run_greg, reps=5)
        results.append(dict(benchmark="global_register_wall", time_us=t_g * 1e6,
                            rate_per_s=1.0 / t_g, gate_tolerance=0.75))
        _progress(f"global_register: {t_g*1e3:.1f} ms wall")

    if not include or "batched_bucketed" in include:
        # four UNEQUAL pairs padded into one bucket and registered together
        # (masked: K1 and K2 once an iteration for all four on the card)
        from icp_tpu_torch.engine.batched import batch_pairs, icp_batched

        sizes = [(len(ref_np), len(tr1_np)),
                 (len(ref_np) * 9 // 10, len(tr1_np) * 8 // 10),
                 (len(ref_np) * 7 // 8, len(tr1_np)),
                 (len(ref_np), len(tr1_np) * 9 // 10)]
        b_pairs = [(ref_np[:nm], tr1_np[:ns]) for nm, ns in sizes]
        models_b, scenes_b, m_ns, s_ns = batch_pairs(b_pairs, quantum=512)
        models_b = torch.as_tensor(models_b, device=dev)
        scenes_b = torch.as_tensor(scenes_b, device=dev)
        B = models_b.shape[0]

        def run_batch(k):
            res = icp_batched(models_b, scenes_b, n_iters=k, solver=solver,
                              nn_method=nn_method, scene_ns=s_ns, model_ns=m_ns)
            float(res.err[0])

        _progress(f"bucketed batch ({B} unequal pairs) ...")
        per_iter, _ = differenced(run_batch, n_iters, n_iters + 180)  # one BATCH iteration
        if per_iter <= 0:
            results.append(_unresolved("batched_bucketed_registrations", per_iter))
        else:
            regs_per_s = B / (per_iter * n_iters)
            results.append(dict(
                benchmark="batched_bucketed_registrations",
                batch=B,
                pair_sizes=[[int(a), int(b)] for a, b in sizes],
                bucket=[int(models_b.shape[1]), int(scenes_b.shape[1])],
                time_us=per_iter * 1e6,
                registrations_per_s=regs_per_s,
                rate_per_s=1.0 / per_iter,
            ))
            _progress(f"bucketed batch: {per_iter*1e6:.1f} us/batch-iter "
                      f"= {regs_per_s:.0f} registrations/s at {n_iters} iters each")

    if not include or "full_loop_sharded" in include:
        # the sharded engine on the process group's mesh (world 1 unless
        # under torchrun): the ring and collectives' cost beside the loop
        from icp_tpu_torch.config import ICPConfig
        from icp_tpu_torch.parallel.mesh import make_mesh
        from icp_tpu_torch.parallel.sharded import icp_sharded

        mesh = make_mesh(dev.type)
        n_dev = mesh.size()
        cfg_sh = ICPConfig(max_iter=1, threshold=0.0, solver=solver,
                           nn_method=nn_method, reference_compat=True)

        def run_sharded(k):
            float(icp_sharded(ref_np, tr1_np, cfg_sh, mesh=mesh, n_iters=k).err)

        _progress(f"full loop (sharded, {n_dev} dev) ...")
        per_iter, t_small = differenced(run_sharded, n_iters, n_iters + 500)
        if per_iter <= 0:
            results.append(_unresolved("full_loop_sharded_per_iter", per_iter))
        else:
            results.append(dict(
                benchmark="full_loop_sharded_per_iter",
                time_us=per_iter * 1e6,
                rate_per_s=1.0 / per_iter,
                point_pairs_per_s=n_pairs / per_iter,
                n_devices=n_dev,
                wall_20_iters_ms=t_small * 1e3,
            ))
            _progress(f"full loop (sharded): {per_iter*1e6:.1f} us/iter "
                      f"({1/per_iter:.0f} iter/s, {n_dev} devices)")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="icp-bench-torch")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--workload", default="cow", choices=["cow", "horse"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default), or the CPU's plain versions")
    args = ap.parse_args(argv)
    chip, power = card_identity() if args.device == "cuda" else (None, None)
    for r in benchmark_matrix(n_iters=args.iters, include=args.only,
                              workload=args.workload, device=args.device):
        r.update(workload=args.workload, chip=chip, power_limit_w=power)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
