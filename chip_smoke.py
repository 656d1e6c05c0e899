#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``icp_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--phases kernels,cli,features,slam,sharded,scale,bench]

Phases, in order; any failure ends the run with a non-zero exit:

  1. device: the card, and ``nvidia-smi``'s name and power limit;
  2. build: ``nvcc`` builds every kernel from ``icp_tpu_torch/csrc``, one
     process per source, all at once, and ptxas's registers, stack frames
     and spills are printed (K1/K10's, K2/K5's, K3's, K7's, K8's and K9's
     kernels must have neither);
  3. kernels: K1-K10 at the shapes of the main paths, each against its plain
     PyTorch version on the same inputs on the card (indices and float32
     outputs exactly equal, float64 sums and state blocks within the stated
     tolerances; K9, whose cross term the tensor cores accumulate, as
     ``hold_k9`` says), with the median times of both (CUDA events) and the
     least time the card could take for the same work (``bound_ms``, from
     this run's inputs); K4's and K7's lines give each table's tiles past
     the capacity, work items and folded pairs (K7: horse's seed, exact and
     capacity-1 tables, the exact pass also without its seed bound), K6 is
     also held at k = 32 and on a lattice of exactly equal distances, and
     K10 (the ``"mxu"`` form) is timed beside K1 at K1's shapes; K2 (one
     warp) at 1 and 23 rows, and K3 (one launch an iteration, its last block
     running K2's step) at cow from two states, three launches bit-equal,
     each with its device microseconds from ``torch.profiler``; K5 (one
     warp) through its packed entry and through ``qcp_rotation_from`` on
     float32 and float64 statistics, bit-equal to plain, one launch a
     call; K8 at cow and the grid seed, bit-equal to plain and to K1, three
     launches alike with its merge workspace clean after each, its and
     K1's device microseconds a call beside each other; K6 and K7 at k = 64
     (lists of two slots a lane, the neighbours FPFH fetches): K6 on bun000
     subsampled to 4,026 rows and on the tied lattice, K7's seed and exact
     launches on horse, exactly equal to plain, the K7 path equal to K6;
     then the pair axis (``pair_axis=`` lines, one launch for B pairs): K1
     on the bunny chain's batch (4 pairs of 40,960 bucketed rows, every
     row against plain and four single launches), K3 at B = 8 and 32 on
     cow-size pairs (three launches, each pair bit-equal to its own launch,
     the workspace clean), K2 at B = 4 and 8, K5 at B = 8 (float32 and
     float64) and K9 at B = 1, 4 and 8 on the cow pairs and on the bunny
     batch (its four outputs; each pair held to plain by ``hold_k9``),
     each bit-equal per pair to its single launch, with a single pair's
     time beside the batch's;
  4. cli: the reference program's path, ``engine.cli.main`` with
     ``--device cuda``: point-to-point on cow_tr1 10 and cow_tr2 10 (fused
     path: one K3 launch an iteration and no K2 launch), horse_tr1 3 (grid
     path) and cow_tr1 10 with ``--nn bcast
     --solver qcp_fused`` (K5), each held against the reference binary's
     fixtures; ``--engine point_to_plane``, ``symmetric`` and ``gicp`` on
     cow_tr1 30 and cow_tr2 30 against the JAX CLI's fixtures, and on
     horse_tr1 30 (grid path, K7 normals) against the port's own dense
     path; the lane-chunked NN (K8) and the ``"mxu"`` form (K10) through
     their entry point at K1's shapes, against K1 and the plain version; the
     ``qcp_fused`` step with the bcast NN on cow (one K5 launch an
     iteration, its device launches an iteration and ms/iter); the
     bf16 prefilter (K9) through ``icp_symmetric`` with ``nn_method="bf16"``
     on a seeded surface and on cow_tr1.  The launch counts of each run are
     read with the counts set to 0 just before it.  Then two repairs: the
     cow_tr1 CLI case and an ``icp_symmetric`` cow_tr1 run under the
     caller's ``torch.set_float32_matmul_precision("high")`` (same
     iterations and a bit-equal trace as under ``"highest"``, and the
     caller's setting back afterwards), and ``icp_fixed_iters`` with a NaN
     coordinate on the fused and the grid path (every iteration runs).
     Then ms/iter of the cow and horse loops of the four engines (and of
     the trimmed point-to-point loops, and horse's bucket-padded one), and
     the normals' ms;
  5. features (``[features]`` lines): trim — the CLI with ``--trim 0.1`` on
     cow_tr1/cow_tr2 (point-to-point: the pipeline, K1 + K2 a launched
     iteration, no K3) and on cow_tr1 for the plane engines, each against
     the JAX CLI's runs (``tests/fixtures/torch_trim/``), and horse_tr1
     trimmed on the grid path (K4 + K2) against the dense trimmed path;
     bucket — horse through ``pad_to_bucket`` (49,152 rows) and
     ``scene_n``/``model_n`` against the unpadded run, point-to-point and
     point-to-plane, and the normals of the sentinel-padded cow (K6) and
     horse (K7, with its exact table past the capacity and folded pairs)
     against the unpadded normals; guard — cow_tr1 with a NaN coordinate
     and ``guard="device"`` raising ``ICPGuardError`` at iteration 1 on the
     fused path (K3) and the pipeline (K1 + K2), a clean guarded run
     bit-equal to the unguarded one with the same launches, and K2's and
     K3's status words bit-equal to their plain versions; resume —
     ``icp_resumable`` killed after one chunk of 3 and resumed, bit-equal
     to the uninterrupted chunked run; metrics — the CLI's ``--metrics
     --metrics-ops`` on cow and horse;
  6. slam (``[slam]`` lines): ``icp_batched`` on cow and cow moved by
     seeded similarities, 10 iterations: bcast/eigh (B = 8), bcast/qcp_fused
     (K5), pallas/eigh (K1) and bf16/eigh and bf16/qcp_fused (K9, K5) at
     B = 8 and 32 held to each pair's ``icp_fixed_iters``, and
     pallas/qcp_fused (K3) at B = 1, 8 and 32 bit-equal to it, each kernel
     launched once an iteration for all the pairs, with ms a pair and a
     pair-iteration; ``register_chain_batched`` on the five bunny scans at
     full resolution (bcast/eigh and bf16/eigh, one K9 launch an iteration,
     held to the padded pairs, pallas/qcp_fused as one K1 and one K2 launch
     an iteration held to them within 1e-6 / 1e-9, and "auto": the grid
     path pair by pair); ``global_register`` on two partly overlapping
     bunny crops held to the known pose; the ``icp-slam-torch`` CLI at the
     flags of the JAX fixtures ``tests/fixtures/torch_slam/`` (dense path)
     and ``torch_slam_grid/`` (``--subsample 4 --nn grid``: K4 must run)
     held to their pairs, closures and poses (``_SLAM_FIXTURES``), and at
     full resolution with ``--init fpfh --detect-closures
     --refine`` (closure 0<-4, trimmed errors under 5e-4, the closure's
     inconsistency shrunk by the pose graph), with its wall seconds and
     launches;
  7. sharded (``[sharded]`` lines): the sharded engines on a world-1 NCCL
     group (``parallel/``), each held against its single-device engine on
     the card (the same iterations, points within atol 1e-4 and rtol
     2e-4): ``icp_sharded`` on cow (K1 each hop, K5 each iteration; ring
     and all-gather traced, trimmed), ``icp_sharded_2d`` on a 1 x 1 mesh,
     the sharded grid (K4 each hop) on horse, horse with a capacity of one
     candidate and the 1M pair (10 iterations, timed over 7-10);
     ``icp_point_to_plane_sharded`` on cow (K6 normals) and it,
     ``icp_symmetric_sharded`` and ``icp_generalized_sharded`` on horse (K7
     normals, K4's normals payload); ``bundle_adjust_sharded`` on the bunny
     chain's correspondences (poses within 1e-5 of ``bundle_adjust``); and
     ``icp-torch --sharded`` on cow_tr1 against the reference fixture.
     Each line gives ms/iter and device launches an iteration beside the
     single-device engine's, the K1, K4, K5, K6 and K7 launches, and the
     card's name and power limit.  Under ``torchrun`` (``python -m
     torch.distributed.run --standalone --nproc-per-node 4 chip_smoke.py
     --phases sharded``) every rank runs the phase on its own card at the
     group's world size, ``icp_sharded_2d`` on a (2, world / 2) mesh, and
     rank 0 alone prints;
  8. scale: a 1,000,000 x 1,000,000 pair (horse upsampled with seeded
     jitter, a known similarity): K4 on the first and the third grid
     iteration's tables, each checked against K1 brute force on 65,536
     seeded scene rows and against the plain version on sampled scene
     tiles, and timed beside its bound; K1 on the 1M bound seed against
     its plain version on 65,536 seeded rows, and K8 on the same seed
     against K1 on every row and its plain version on the same rows, each
     with its device microseconds; 10 fixed point-to-point grid
     iterations; K7 on the 1M model's seed and exact tables against its
     plain version on sampled tiles; K7 normals of both clouds, the model's
     neighbours checked against K6 on 16,384 seeded rows; 10 fixed grid
     iterations of the point-to-plane, symmetric and GICP engines, each
     with a falling error; the 10 point-to-point grid iterations again with
     ``trim_fraction=0.1`` (a ``[features] case=scale_trim`` line);
  9. bench (``[bench]`` lines): the port's harness
     (``icp_tpu_torch/bench/``) on the card, one row a call with the counts
     set to 0 just before it: every row at cow and every row but the host
     NumPy engine at horse, each a positive time or ``unresolved``, every
     utilization share at most 100%, the loop rows' launches once an
     iteration (the fused row K3 alone, the pipeline row K1 and K2 and no
     K3, the grid row K4 and K2, the batched row one K1 and one K2 for its
     four pairs; cow's three loop paths in a short run, their times being
     ``bench_torch.py``'s), the op rows their kernel and the torch rows
     none; one scaling cell (65,536 points, 5 iterations) at world 1
     (NCCL); the first launch of K1/K10, K2, K5, K4 and K6 at each shape
     the rows gave them held against the plain version on its inputs (K1
     and K6 on 16,384 seeded rows above 2^28 pairs; the pair axis also
     against each pair's single launch), a ``[bench] held`` line each; and
     ``python3 bench_torch.py`` as a child: rc 0, its gate at 7 iterations,
     and the headline record ``icp_iter_per_s_cow`` at 20 and 520
     iterations on its last line.

The last three lines of standard output are the kernels' JSON record, the
``nvidia-smi`` line and ``{"ok": true, "device": {...}}``.  Without a CUDA
device the script exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
# The bounds' one formula and its operation counts (fails outside a checkout).
from icp_tpu_torch.bench.roofline import (  # noqa: E402
    BF16_F32_PAIR_OPS,
    BF16_PAIR_OPS,
    PAIR_OPS,
    PEAK_BF16,
    PEAK_FLOPS,
    ROTATION_OPS,
    bf16_bound,
    bound,
    fused_ops,
    step_ops,
)

FIXDIR = os.path.join(ROOT, "tests", "fixtures", "reference")
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
_TRACE_RE = re.compile(r"\[ICP\] iteration number (\d+) \| error value = (\S+)")

KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "nn_dense": ("icp_tpu_torch/csrc/nn_dense.cu", "icp_tpu/kernels/nn_pallas.py:99"),
    "qcp_step": ("icp_tpu_torch/csrc/qcp.cu", "icp_tpu/kernels/qcp_pallas.py:122"),
    "icp_fused": ("icp_tpu_torch/csrc/icp_fused.cu", "icp_tpu/kernels/icp_fused.py:128"),
    "nn_grid": ("icp_tpu_torch/csrc/nn_grid.cu", "icp_tpu/kernels/nn_grid.py:240"),
    "qcp_rotation": ("icp_tpu_torch/csrc/qcp.cu", "icp_tpu/kernels/qcp_pallas.py:32"),
    "knn_dense": ("icp_tpu_torch/csrc/knn_dense.cu", "icp_tpu/kernels/knn_pallas.py:59"),
    "knn_grid": ("icp_tpu_torch/csrc/knn_grid.cu", "icp_tpu/kernels/knn_grid.py:53"),
    "nn_chunked": ("icp_tpu_torch/csrc/nn_chunked.cu", "icp_tpu/kernels/nn_pallas.py:49"),
    "nn_bf16": ("icp_tpu_torch/csrc/nn_bf16.cu", "icp_tpu/kernels/nn_bf16.py:60"),
    "nn_dense_mxu": ("icp_tpu_torch/csrc/nn_dense.cu", "icp_tpu/kernels/nn_pallas.py:105"),
}
# (fixture, model file, scene file, nb_iter, iterations, output atol, extra flags)
CLI_CASES = [
    ("cow_tr1", "cow_ref.txt", "cow_tr1.txt", 10, 7, 1e-5, []),
    ("cow_tr2", "cow_ref.txt", "cow_tr2.txt", 10, 10, 1e-5, []),
    ("horse_tr1", "horse_ref.txt", "horse_tr1.txt", 3, 3, 2e-6, []),
    ("cow_tr1", "cow_ref.txt", "cow_tr1.txt", 10, 7, 1e-5, ["--nn", "bcast", "--solver", "qcp_fused"]),
]
# the plane engines against the JAX CLI's fixtures:
# engine -> (fixture folder, short label, {pair: iterations})
PLANE_CASES = {
    "point_to_plane": ("torch_p2pl", "p2pl", {"cow_tr1": 3, "cow_tr2": 6}),
    "symmetric": ("torch_sym", "sym", {"cow_tr1": 3, "cow_tr2": 5}),
    "gicp": ("torch_gicp", "gicp", {"cow_tr1": 3, "cow_tr2": 4}),
}
# the engines that estimate normals of both clouds
BOTH_NORMALS = ("symmetric", "gicp")
TRACE_RTOL = 1e-2  # on entries > 1e-6: float32 coordinates, see ROADMAP C6
NORMAL_K = 17  # the normals' k_eff: 16 neighbours and the point itself
FPFH_K = 64  # the neighbours fpfh_features fetches: max(k + 1, orient_k = 64)
BUNNY = ["bun000", "bun045", "bun180", "bun270", "bun315"]
# The closure threshold of the full-resolution SLAM run: 2,048 random rows
# of a whole scan score the closure 0<-4 at 0.093 (the port) and 0.098
# (JAX, seed 0) on the CPU, below the CLI's default 0.15 in both, and the
# best wrong pair at 0.034-0.044; 0.06 lies between.
FULL_CLOSURE_MIN = 0.06
K1_NAMES = ("nn_dense_fold_kernel", "nn_dense_epilogue_kernel")  # K1's kernels in a trace


class SmokeError(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeError(what)


def say(phase: str, **numbers) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in numbers.items()), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def same_nan(a, b) -> bool:
    """Bit-equal, NaN where the other is NaN."""
    import torch

    return bool(torch.equal(torch.isnan(a), torch.isnan(b))) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def sqdist(p, y):
    """Row-wise float32 diff-squares distance (dx*dx + dy*dy) + dz*dz."""
    d = p - y
    return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]


def hold_k9(label: str, s, m, outs) -> dict:
    """K9's (idx, best, second, d_exact) on the centred clouds ``s``, ``m``
    against its plain version.  The tensor cores accumulate the three exact
    bf16 products of the cross term in their own way, which need not round
    as the plain version's (x + y) + z does, so every output need not be
    bit-equal (``equal`` says whether it was).  Held always:
      1. d_exact bit-equal to the diff-squares distance to model[idx];
      2. best and second within delta = 3 * 2^-20 * Pmax * Mmax of the plain
         version's (``cross_term_slack``, ~21,800x below B);
      3. idx equal to the plain index on every row whose plain margin
         second - best exceeds 2 delta;
      4. certified rows equal K1, and d_exact >= K1's distance."""
    import torch

    from icp_tpu_torch.kernels import nn_bf16, nn_dense

    idx, best, second, dex = outs
    ip, bp, sp, dp = nn_bf16.nn_bf16_plain(s, m)
    equal = all(torch.equal(a, b) for a, b in zip(outs, (ip, bp, sp, dp)))
    delta = float(nn_bf16.cross_term_slack(s, m))
    require(torch.equal(dex, sqdist(s, m[idx.long()])),
            f"K9 {label}: d_exact is not the distance to model[idx]")
    fin = torch.isfinite(sp)
    require(torch.equal(torch.isinf(second), ~fin), f"K9 {label}: second's infinities differ")
    err = max(max_abs(best, bp), max_abs(second[fin], sp[fin]))
    require(err <= delta, f"K9 {label}: best/second {err:.3e} from plain, above {delta:.3e}")
    clear = (sp - bp) > 2 * delta
    require(torch.equal(idx[clear], ip[clear]), f"K9 {label}: an index with a clear margin differs")
    ik1, d1 = nn_dense.nn_dense(s, m, with_dist=True)
    cert = (second - best) > 2.0 * nn_bf16.cross_term_bound(s, m)
    require(torch.equal(idx[cert], ik1[cert]), f"K9 {label}: a certified index is not the NN")
    require(bool((dex >= d1).all()), f"K9 {label}: d_exact below the NN distance")
    return {"equal": equal, "best_share": float((best == bp).double().mean()),
            "idx_share": float((idx == ip).double().mean()), "delta": delta, "max_abs_err": err,
            "k1_share": float((idx == ik1).double().mean())}


def folded_pairs(counts, cap: int, nj: int, tm: int, tn: int) -> int:
    """(query, model row) pairs a work-list launch folds for this table: one
    scene tile against one model tile per work item (a tile's candidates,
    or every tile past the capacity)."""
    from icp_tpu_torch.kernels.nn_grid import work_item_offsets

    return int(work_item_offsets(counts, cap, nj)[-1]) * tm * tn


def k4_table(cand, counts, nj: int, tm: int, tn: int) -> dict:
    """The shape of a K4 launch: tiles folding all Nj tiles, mean candidate
    count, work items, folded (point, model row) pairs."""
    cap = cand.shape[1]
    pairs = folded_pairs(counts, cap, nj, tm, tn)
    return {"fallback_tiles": int((counts > cap).sum()),
            "mean_count": f"{counts.double().mean().item():.2f}",
            "items": pairs // (tm * tn), "folded_pairs": pairs}


def k7_table(cand, counts, nj: int, tm: int, tn: int) -> dict:
    """The shape of a K7 launch: tiles folding all Nj tiles, mean candidate
    count, work items (and the scratch slots of the tiles of more than
    one), folded (query, model row) pairs."""
    from icp_tpu_torch.kernels.knn_grid import knn_work_items

    cap = cand.shape[1]
    first, slots = knn_work_items(counts, cap, nj)
    return {"fallback_tiles": int((counts > cap).sum()),
            "mean_count": f"{counts.double().mean().item():.2f}",
            "items": int(first[-1]), "merge_slots": int(slots[-1]),
            "folded_pairs": folded_pairs(counts, cap, nj, tm, tn)}


def device_us(fn, names, reps: int = 20) -> float:
    """Microseconds on the device a call of ``fn`` spends in the kernels
    named in ``names`` (substrings): the sum over the names of the mean of
    each one's launches in ``reps`` calls, from ``torch.profiler`` (a
    launch the trace drops does not count as a zero); NaN if it saw none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        name = next((k for k in names if k in e.name), None)
        if e.device_type == DeviceType.CUDA and name:
            per.setdefault(name, []).append(e.time_range.end - e.time_range.start)
    return sum(sum(v) / len(v) for v in per.values()) if per else float("nan")


def launches_per_iter(run, k: int = 20) -> float:
    """Device launches (kernels, copies and memsets) an iteration of
    ``run(i)`` (a run of i iterations): the difference of a (k + 1)- and a
    1-iteration run under ``torch.profiler``, over k."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for i in (1, k + 1):
        run(i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(i)
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA))
    return (counts[1] - counts[0]) / k


def _fused_launches(prep, starts: dict) -> float:
    """K3's launch from each state of ``starts`` against its plain version
    (``fused_partials_plain`` + ``qcp_step_plain``): the rows' sums within
    relative 1e-9, the state within 1e-8 and the control equal; the state
    bit-equal to K2's plain step on the launch's own rows; three launches
    bit-equal, the workspace clean after each.  Returns the largest
    difference."""
    import torch

    from icp_tpu_torch.kernels import icp_fused, qcp

    dev = prep.p0.device
    worst = 0.0
    for label, st0 in starts.items():
        runs = []
        for _ in range(3):
            st, ctl, errs = st0.clone(), qcp.new_loop_control(4, dev), qcp.new_err_buffer(4, dev)
            icp_fused.fused_icp_step(prep, st, ctl, errs, threshold=1e-5, err_factor=2.0)
            clean = bool((prep.keys == -1).all()) and bool((prep.counts == 0).all())
            require(clean, f"K3 {label}: the workspace is not clean after a launch")
            runs.append((st, ctl, errs[:1], prep.rows.clone()))  # errs[1:]: untouched NaN
        st, ctl, errs, rows = runs[0]
        repeat = all(all(torch.equal(a, b) for a, b in zip(r, runs[0])) for r in runs[1:])
        require(repeat, f"K3 {label}: three launches differ")
        want = icp_fused.fused_partials_plain(prep, st0)
        rel = float(((rows.sum(0) - want[0]).abs() / want[0].abs().clamp(min=1.0)).max())
        require(rel <= 1e-9, f"K3 {label}: sums differ from plain by {rel}")
        pst, pctl, perrs = st0.clone(), qcp.new_loop_control(4, dev), qcp.new_err_buffer(4, dev)
        qcp.qcp_step_plain(want, pst, pctl, perrs, threshold=1e-5, err_factor=2.0)
        err = max(max_abs(st, pst), max_abs(errs, perrs[:1]))
        require(torch.equal(ctl, pctl), f"K3 {label}: loop control differs from plain")
        require(err <= 1e-8, f"K3 {label}: state differs from plain by {err}")
        own, octl, oerrs = st0.clone(), qcp.new_loop_control(4, dev), qcp.new_err_buffer(4, dev)
        qcp.qcp_step_plain(rows, own, octl, oerrs, threshold=1e-5, err_factor=2.0)
        require(torch.equal(own, st) and torch.equal(oerrs[:1], errs),
                f"K3 {label}: the last block's step differs from K2's plain step on its rows")
        worst = max(worst, err, rel)
        say("kernels", kernel="icp_fused", start=label, rows=rows.shape[0],
            sums_max_rel_err=rel, state_max_abs_err=err, own_rows_step_bit_equal=True,
            bit_repeat=repeat, workspace_clean=True)
    return worst


def entry(err, ms, plain_ms, bound_ms_by, library_ms=None) -> dict:
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms_by[0],
            "bound_by": bound_ms_by[1], "library_ms": library_ms}


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, smi=repr(smi))
    require(not torch.backends.cuda.matmul.allow_tf32,
            "TF32 matmuls are on; the apply and sums need full float32")
    return smi.splitlines()[0]


def phase_build():
    from icp_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.lib()
    say("build", seconds=f"{time.perf_counter() - t0:.2f}",
        nvcc_seconds=f"{_build.build_info['seconds']:.2f}",
        cached=_build.build_info["cached"])
    log = _build.build_info.get("ptxas", "")
    regs = re.findall(r"Function properties for (\S+)|Used (\d+) registers", log)
    if regs:
        print("[build] ptxas: " + " ".join(a or b for a, b in regs), flush=True)
    # stack frame and spill bytes of each kernel: a list indexed at run
    # time would show here (K1/K10's, K2/K5's, K3's, K7's, K8's and K9's
    # must have none)
    frames = re.findall(r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, "
                        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    if frames:
        print("[build] ptxas stack/spill bytes: " + " ".join(
            f"{name}={f}/{st}/{ld}" for name, f, st, ld in frames), flush=True)
        held = ("_nn_dense_cu", "_knn_grid_cu", "_nn_bf16_cu", "_icp_fused_cu", "_qcp_cu",
                "_nn_chunked_cu")
        for src in held:
            require(any(src in name for name, *_ in frames), f"ptxas reported no {src} kernel")
        bad = [name for name, f, st, ld in frames
               if any(src in name for src in held) and (f, st, ld) != ("0", "0", "0")]
        require(not bad, f"K1/K10, K2/K5, K3, K7, K8 or K9 kernels with a stack frame or spills: {bad}")


def _load(name):
    from icp_tpu_torch.io.csv import load_matrix

    with contextlib.redirect_stderr(io.StringIO()):
        return load_matrix(os.path.join(ROOT, "data", name))


def tied_lattice(seed: int):
    """(queries, points) on the card: the 16^3 integer sites, each twice, and
    the sites moved by seeded half steps, so most neighbour distances tie."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    g = np.arange(16, dtype=np.float32)
    sites = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    f32 = dict(dtype=torch.float32, device="cuda")
    return (torch.tensor(sites + 0.5 * rng.integers(0, 2, sites.shape), **f32),
            torch.tensor(np.concatenate([sites[::-1], sites]), **f32))


def k7_launches(q, kgrid, tn: int, cap: int, *, cap1: bool = False, sample=None,
                phase: str = "kernels", k: int = NORMAL_K) -> dict:
    """K7's seed and exact launches (and, with ``cap1``, the exact pass on
    a capacity-1 table) for the kd-sorted query ``q`` against ``kgrid``:
    each held bit for bit against its plain version (on the query tiles
    ``sample(cand, counts)`` picks, where given), timed beside its bound;
    the exact pass also without its bound, and each line gives its table's
    tiles past the capacity, work items and folded pairs."""
    import torch

    from icp_tpu_torch.kernels import _build, knn_grid, nn_grid

    nj, tm = kgrid.tiles.shape[0], kgrid.model_tile
    bd2 = nn_grid.tile_box_dists(q, kgrid, scene_tile=tn)
    seed_tab = knn_grid.seed_table(bd2, k, tm)
    d_seed, _ = knn_grid.knn_worklist(*seed_tab, q, kgrid.tiles, tn, k)
    kth = d_seed[:, k - 1].contiguous()
    tables = {"seed": (seed_tab, None),
              "exact": (knn_grid.cull_table(bd2, kth, tn, min(cap, nj)), kth)}
    if cap1:
        tables["exact_cap1"] = (knn_grid.cull_table(bd2, kth, tn, 1), kth)
    del bd2
    heavy = q.shape[0] > 100_000
    out = {}
    for label, ((cand, counts), kb) in tables.items():
        args = (cand, counts, q, kgrid.tiles, tn, k)
        before = _build.LAUNCHES["knn_grid"]
        dk, ik = knn_grid.knn_worklist(*args, bound=kb)
        launches = _build.LAUNCHES["knn_grid"] - before
        if sample is None:
            dp, ip = knn_grid.knn_worklist_plain(*args, bound=kb)
            rows = slice(None)
        else:
            sel = sample(cand, counts)
            rows = (sel[:, None] * tn + torch.arange(tn, device=q.device)).flatten()
            dp, ip = knn_grid.knn_worklist_plain(
                cand[sel].contiguous(), counts[sel].contiguous(), q[rows].contiguous(),
                kgrid.tiles, tn, k, None if kb is None else kb[rows].contiguous())
        require(torch.equal(ik[rows], ip), f"K7 {label}: indices differ from plain")
        err = max_abs(dk[rows], dp)
        require(err == 0.0, f"K7 {label}: d2 differs from plain by {err}")
        if kb is not None:  # the bound changes nothing but the work
            d0, i0 = knn_grid.knn_worklist(*args)
            require(torch.equal(i0, ik) and torch.equal(d0, dk),
                    f"K7 {label}: the result depends on the bound")
        ms = cuda_ms(lambda: knn_grid.knn_worklist(*args, bound=kb), 5 if heavy else 10)
        plain_ms = None
        if sample is None and label != "exact_cap1":
            plain_ms = cuda_ms(lambda: knn_grid.knn_worklist_plain(*args, bound=kb), 2, warmup=1)
        shape = k7_table(cand, counts, nj, tm, tn)
        ops = PAIR_OPS * shape["folded_pairs"]
        nbts = nbytes(cand, counts, q, kgrid.tiles, kb) + 8 * q.shape[0] * k
        b = bound(ops, nbts)
        out[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "ops": ops,
                      "bytes": nbts}
        say(phase, kernel="knn_grid", launch=label, k=k, tiles=f"{cand.shape[0]}x{nj}",
            query_tile=tn,
            capacity=cand.shape[1], **shape, with_bound=kb is not None, launches=launches,
            checked_tiles="all" if sample is None else int(sel.numel()), equal_plain=True,
            ms=f"{ms:.4f}", plain_ms="not timed" if plain_ms is None else f"{plain_ms:.4f}",
            bound_ms=f"{b[0]:.4f}", bound_by=b[1])
    return out


def phase_kernels(seed: int, record: dict):
    import numpy as np
    import torch

    from icp_tpu_torch.engine.grid import _prepare_scene
    from icp_tpu_torch.kernels import (
        _build,
        icp_fused,
        knn_dense,
        nn_bf16,
        nn_dense,
        nn_grid,
        qcp,
    )
    from icp_tpu_torch.ops.alignment import Similarity, compute_alignment_stats
    from icp_tpu_torch.ops.normals import estimate_normals, knn_indices

    dev = torch.device("cuda")
    f32 = dict(dtype=torch.float32, device=dev)
    cow_ref = torch.tensor(_load("cow_ref.txt"), **f32)
    cow_tr1 = torch.tensor(_load("cow_tr1.txt"), **f32)
    horse_ref = torch.tensor(_load("horse_ref.txt"), **f32)
    horse_tr1 = torch.tensor(_load("horse_tr1.txt"), **f32)

    # K1: cow 2,903^2, and the grid path's bound seed (kd-padded horse scene
    # x every 16th model point).
    p0, _, _, tn, _ = _prepare_scene(horse_tr1, 256)
    p0 = p0.contiguous()
    sub = horse_ref[::16].contiguous()
    k1 = {}
    for label, s, m in (("cow", cow_tr1, cow_ref), ("horse_seed", p0, sub)):
        ik, dk = nn_dense.nn_dense(s, m, with_dist=True)
        ip, dp = nn_dense.nn_dense_plain(s, m, with_dist=True)
        require(torch.equal(ik, ip), f"K1 {label}: indices differ from plain")
        k1[label] = (max_abs(dk, dp), cuda_ms(lambda: nn_dense.nn_dense(s, m), 20),
                     cuda_ms(lambda: nn_dense.nn_dense_plain(s, m), 5))
        require(torch.equal(dk, dp), f"K1 {label}: d2 differs from plain")
        say("kernels", kernel="nn_dense", shape=f"{s.shape[0]}x{m.shape[0]}",
            chunk_rows=nn_dense.chunk_rows(s.shape[0], m.shape[0]),
            idx_equal=True, d2_max_abs_err=k1[label][0],
            ms=f"{k1[label][1]:.4f}", plain_ms=f"{k1[label][2]:.4f}")
    n, m = p0.shape[0], sub.shape[0]
    record["nn_dense"] = entry(max(v[0] for v in k1.values()), *k1["horse_seed"][1:],
                               bound(PAIR_OPS * n * m, 12 * n + 12 * m + 4 * n))

    # K10, the "mxu" form: K1's shapes, indices and distances bit-equal to
    # its plain version, timed beside K1 with the same pair bound; where its
    # index differs from K1's, the two candidates' diff-squares distances
    # must lie within 4 ulp of the expansion's terms.
    k10 = {}
    for label, s, m in (("cow", cow_tr1, cow_ref), ("horse_seed", p0, sub)):
        ik, dk = nn_dense.nn_dense(s, m, with_dist=True, distance_impl="mxu")
        ip, dp = nn_dense.nn_dense_plain(s, m, with_dist=True, distance_impl="mxu")
        require(torch.equal(ik, ip), f"K10 {label}: indices differ from plain")
        require(torch.equal(dk, dp), f"K10 {label}: distances differ from plain")
        ik1 = nn_dense.nn_dense(s, m)
        off = torch.nonzero(ik != ik1).flatten()
        if off.numel():
            ps = s[off]
            gap = (sqdist(ps, m[ik[off].long()]).double()
                   - sqdist(ps, m[ik1[off].long()]).double()).abs()
            tol = 4 * 2.0 ** -24 * (float(sqdist(m, torch.zeros_like(m)).max())
                                    + sqdist(ps, torch.zeros_like(ps)).double())
            require(bool((gap <= tol).all()), f"K10 {label}: an index off K1's by more than 4 ulp")
        n, m_rows = s.shape[0], m.shape[0]
        b = bound(PAIR_OPS * n * m_rows, 12 * n + 12 * m_rows + 4 * n)
        k10[label] = entry(0.0, cuda_ms(lambda: nn_dense.nn_dense(s, m, distance_impl="mxu"), 20),
                           cuda_ms(lambda: nn_dense.nn_dense_plain(s, m, distance_impl="mxu"), 5),
                           b)
        say("kernels", kernel="nn_dense_mxu", shape=f"{n}x{m_rows}",
            chunk_rows=nn_dense.chunk_rows(n, m_rows, "mxu"), equal_plain=True,
            idx_equal_k1_share=f"{float((ik == ik1).double().mean()):.6f}",
            ms=f"{k10[label]['ms']:.4f}", plain_ms=f"{k10[label]['plain_ms']:.4f}",
            k1_ms=f"{cuda_ms(lambda: nn_dense.nn_dense(s, m), 20):.4f}", bound_ms=f"{b[0]:.4f}")
    record["nn_dense_mxu"] = k10["horse_seed"]

    # K2: statistics of a seeded random correspondence set, as one row
    # (grid engine) and as 23 rows (fused path), from a non-identity state.
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((1000, 3))
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    Rq = np.array([[w*w+x*x-y*y-z*z, 2*(x*y-w*z), 2*(x*z+w*y)],
                   [2*(x*y+w*z), w*w-x*x+y*y-z*z, 2*(y*z-w*x)],
                   [2*(x*z-w*y), 2*(y*z+w*x), w*w-x*x-y*y+z*z]])
    ys = 1.3 * pts @ Rq.T + rng.standard_normal(3) + 1e-3 * rng.standard_normal((1000, 3))
    P = torch.tensor(pts, dtype=torch.float64, device=dev)
    Y = torch.tensor(ys, dtype=torch.float64, device=dev)
    prev = qcp.pack_total_state(Similarity(torch.tensor(0.9), torch.tensor(Rq.T),
                                           torch.tensor([0.1, -0.2, 0.3])), dev)
    k2 = {}
    for rows in (1, 23):
        parts = torch.cat([qcp.pack_stats(compute_alignment_stats(a, b))
                           for a, b in zip(P.chunk(rows), Y.chunk(rows))]).contiguous()
        outs = []
        for fn in (qcp.qcp_step, qcp.qcp_step_plain):
            st, ctl, errs = prev.clone(), qcp.new_loop_control(4, dev), qcp.new_err_buffer(4, dev)
            fn(parts, st, ctl, errs, with_scale=True, threshold=1e-5, err_factor=2.0)
            outs.append((st, ctl, errs))
        (sk, ck, ek), (sp, cp, ep) = outs
        require(torch.equal(ck, cp), "K2: loop control differs from plain")
        err = max(max_abs(sk, sp), max_abs(ek[:1], ep[:1]))
        require(err <= 1e-9, f"K2 {rows} rows: state differs from plain by {err}")

        def k2_bench(fn, parts=parts):
            st, ctl, errs = prev.clone(), qcp.new_loop_control(1 << 20, dev), qcp.new_err_buffer(1 << 20, dev)
            return lambda: fn(parts, st, ctl, errs, threshold=-math.inf)

        # ~600 float64 operations on the summed rows; reads the rows and the
        # state, writes the state, the control and one error
        k2[rows] = entry(err, cuda_ms(k2_bench(qcp.qcp_step), 50),
                         cuda_ms(k2_bench(qcp.qcp_step_plain), 10),
                         bound(step_ops(rows), nbytes(parts) + 2 * 32 * 8 + 2 * 3 * 4 + 8))
        say("kernels", kernel="qcp_step", rows=rows, warp=True, state_max_abs_err=err,
            bit_equal=err == 0.0, ms=f"{k2[rows]['ms']:.4f}",
            device_us=f"{device_us(k2_bench(qcp.qcp_step), ('qcp_step_kernel',)):.2f}",
            plain_ms=f"{k2[rows]['plain_ms']:.4f}", bound_ms=f"{k2[rows]['bound_ms']:.3g}")
    # the main paths launch K2 with one row (the grid and pipeline paths)
    record["qcp_step"] = dict(k2[1], max_abs_err=max(v["max_abs_err"] for v in k2.values()))

    # K3: one launch an iteration, its last block solving; cow, from the
    # identity and from a non-identity state.
    prep = icp_fused.prepare_fused_inputs(cow_tr1, cow_ref)
    k3_err = _fused_launches(prep, {"identity": qcp.identity_state(dev), "warm": prev})
    bench = (qcp.identity_state(dev), qcp.new_loop_control(1 << 20, dev),
             qcp.new_err_buffer(1 << 20, dev))

    def k3_launch():
        icp_fused.fused_icp_step(prep, *bench, threshold=-math.inf)

    def k3_plain():
        st, ctl, errs = bench
        qcp.qcp_step_plain(icp_fused.fused_partials_plain(prep, st), st, ctl, errs,
                           threshold=-math.inf)

    n = m = cow_ref.shape[0]
    blocks = prep.rows.shape[0]
    # expansion-form distance: 3 mul + 3 add a pair, and K2's ~600 float64
    # operations; the scene (12 B) and the pre-scaled model (16 B) a row
    # in, the state, the control and an error in and out, and the scene
    # blocks' 18 sums out
    record["icp_fused"] = entry(
        k3_err, cuda_ms(k3_launch, 50), cuda_ms(k3_plain, 10),
        bound(fused_ops(n, m), 12 * n + 16 * m + blocks * 18 * 8 + 2 * (32 * 8 + 12) + 8))
    say("kernels", kernel="icp_fused", shape=f"{n}x{m}",
        grid=f"{blocks}x{-(-m // icp_fused.chunk_rows(n, m))}",
        ms=f"{record['icp_fused']['ms']:.4f}",
        device_us=f"{device_us(k3_launch, ('icp_fused_kernel',)):.2f}",
        plain_ms=f"{record['icp_fused']['plain_ms']:.4f}",
        bound_ms=f"{record['icp_fused']['bound_ms']:.5f}")

    # K4: horse, the first iteration's real candidate table, and the
    # forced-overflow table (max_candidates=1: every tile folds all tiles);
    # then the payload slot with the horse normals (3 wide).
    grid = nn_grid.build_model_grid(horse_ref, target_tile=1024)
    u0 = nn_grid.bound_from_indices(p0, grid, nn_grid.initial_bound_indices(p0, horse_ref))
    idx_bf = nn_dense.nn_dense(p0, horse_ref)
    nj, tm = grid.tiles.shape[0], grid.tiles.shape[1]
    kd = dict(kd_row=grid.kd_row)
    k4_err, k4 = 0.0, None
    for cap in (16, 1):
        cand, counts, over = nn_grid.candidates(p0, u0, grid, scene_tile=tn, cap=cap)
        args = (cand, counts, p0, grid.tiles, tn)
        dk, ik, yk, _ = nn_grid.nn_grid(*args, **kd)
        dp, ip, yp, _ = nn_grid.nn_grid_plain(*args, **kd)
        require(torch.equal(ik, ip), f"K4 cap={cap}: indices differ from plain")
        require(torch.equal(ik, idx_bf), f"K4 cap={cap}: indices differ from brute force")
        require(torch.equal(yk, horse_ref[ik.long()]), f"K4 cap={cap}: y is not the winner")
        err = max(max_abs(dk, dp), max_abs(yk, yp))
        require(err == 0.0, f"K4 cap={cap}: d2/y differ from plain by {err}")
        k4_err = max(k4_err, err)
        times = (cuda_ms(lambda: nn_grid.nn_grid(*args, **kd), 20),
                 cuda_ms(lambda: nn_grid.nn_grid_plain(*args, **kd), 3))
        shape = k4_table(cand, counts, nj, tm, tn)
        b = bound(PAIR_OPS * shape["folded_pairs"], nbytes(cand, counts, p0, grid.tiles)
                  + p0.shape[0] * (4 + 4 + 12))
        if k4 is None:  # the real table: the numbers of the record
            k4 = (*times, b)
        say("kernels", kernel="nn_grid", max_candidates=cap, tiles=f"{cand.shape[0]}x{nj}",
            overflow=bool(over), **shape, idx_equal=True, max_abs_err=err,
            ms=f"{times[0]:.4f}", plain_ms=f"{times[1]:.4f}", bound_ms=f"{b[0]:.4f}")
    normals = estimate_normals(horse_ref, method="dense")
    pgrid = nn_grid.build_model_grid(horse_ref, target_tile=1024, payload=normals)
    cand, counts, _ = nn_grid.candidates(p0, u0, pgrid, scene_tile=tn, cap=16)
    args = (cand, counts, p0, pgrid.tiles, tn, pgrid.payload)
    dk, ik, yk, plk = nn_grid.nn_grid(*args, kd_row=pgrid.kd_row)
    dp, ip, yp, plp = nn_grid.nn_grid_plain(*args, kd_row=pgrid.kd_row)
    require(torch.equal(ik, ip) and torch.equal(ik, idx_bf), "K4 payload: indices differ")
    require(torch.equal(plk[:, :3], normals[ik.long()]), "K4 payload: not the winner's normal")
    err = max(max_abs(dk, dp), max_abs(yk, yp), max_abs(plk, plp))
    require(err == 0.0, f"K4 payload: d2/y/payload differ from plain by {err}")
    pl_ms = (cuda_ms(lambda: nn_grid.nn_grid(*args, kd_row=pgrid.kd_row), 20),
             cuda_ms(lambda: nn_grid.nn_grid_plain(*args, kd_row=pgrid.kd_row), 3))
    say("kernels", kernel="nn_grid", payload=3, idx_equal=True, max_abs_err=err,
        ms=f"{pl_ms[0]:.4f}", plain_ms=f"{pl_ms[1]:.4f}")
    record["nn_grid"] = entry(k4_err, *k4)

    # K5: the rotation solve on the cow statistics (first matches), through
    # the packed (1, 16) entry and through qcp_rotation_from on float32
    # statistics (as the bcast loop holds them) and on float64 ones; every
    # output bit-equal to the plain version.
    stats = compute_alignment_stats(cow_tr1, cow_ref[nn_dense.nn_dense(cow_tr1, cow_ref).long()])
    mu_p, mu_y = stats.sum_p / stats.n, stats.sum_y / stats.n
    S = stats.sum_py - stats.n * torch.outer(mu_p, mu_y)
    gp = stats.sum_pp - stats.n * torch.dot(mu_p, mu_p)
    gy = stats.sum_yy - stats.n * torch.dot(mu_y, mu_y)
    packed = qcp.pack_rotation_input(S, gp, gy)
    rk, rp = qcp.qcp_rotation(packed), qcp.qcp_rotation_plain(packed)
    k5_err = max_abs(rk, rp)
    require(k5_err == 0.0, f"K5: output differs from plain by {k5_err}")
    R = rk[0, :9].reshape(3, 3)
    require(max_abs(R @ R.T, torch.eye(3, dtype=R.dtype, device=dev)) <= 1e-12, "K5: R not a rotation")
    k5_from = {}
    for dt in (torch.float32, torch.float64):
        args = (S.to(dt), gp.to(dt), gy.to(dt))
        before = _build.LAUNCHES["qcp_rotation"]
        got = qcp.qcp_rotation_from(*args)
        require(_build.LAUNCHES["qcp_rotation"] == before + 1, "K5 from: not one launch a call")
        want = qcp.qcp_rotation_from_plain(*args)
        require(got[0].dtype == dt and all(torch.equal(a, b) for a, b in zip(got, want)),
                f"K5 from {dt}: differs from plain")
        require(torch.equal(want[0], rp[0, :9].reshape(3, 3).to(dt)),
                f"K5 from {dt}: plain differs from the packed plain")
        k5_from[dt] = (cuda_ms(lambda: qcp.qcp_rotation_from(*args), 50),
                       device_us(lambda: qcp.qcp_rotation_from(*args), ("qcp_rotation_kernel",)),
                       cuda_ms(lambda: qcp.qcp_rotation_from_plain(*args), 10))
    # ~500 dependent float64 operations; S, gp and gy in float32, the (1,
    # 16) float64 block and R in float32 out
    record["qcp_rotation"] = entry(k5_err, k5_from[torch.float32][0], k5_from[torch.float32][2],
                                   bound(ROTATION_OPS, 11 * 4 + 16 * 8 + 9 * 4))
    say("kernels", kernel="qcp_rotation", warp=True, max_abs_err=k5_err,
        packed_ms=f"{cuda_ms(lambda: qcp.qcp_rotation(packed), 50):.4f}",
        packed_device_us=f"{device_us(lambda: qcp.qcp_rotation(packed), ('qcp_rotation_kernel',)):.2f}",
        packed_plain_ms=f"{cuda_ms(lambda: qcp.qcp_rotation_plain(packed), 10):.4f}",
        **{f"from_{str(dt)[6:]}_{k}": f"{v:.4f}" for dt, vals in k5_from.items()
           for k, v in zip(("ms", "device_us", "plain_ms"), vals)},
        from_bit_equal=True, bound_ms=f"{record['qcp_rotation']['bound_ms']:.3g}")

    # K6: the normals' kNN at cow (2,903^2) and horse (48,485^2), k 17.
    k6 = {}
    for label, cloud in (("cow", cow_ref), ("horse", horse_ref)):
        dk, ik = knn_dense.knn_dense(cloud, cloud, NORMAL_K)
        dp, ip = knn_dense.knn_dense_plain(cloud, cloud, NORMAL_K)
        require(torch.equal(ik, ip), f"K6 {label}: indices differ from plain")
        err = max_abs(dk, dp)
        require(err == 0.0, f"K6 {label}: d2 differs from plain by {err}")
        n = cloud.shape[0]
        heavy = n > 10_000
        k6[label] = entry(err, cuda_ms(lambda: knn_dense.knn_dense(cloud, cloud, NORMAL_K),
                                       5 if heavy else 20),
                          cuda_ms(lambda: knn_dense.knn_dense_plain(cloud, cloud, NORMAL_K),
                                  2 if heavy else 5, warmup=1),
                          bound(PAIR_OPS * n * n, 24 * n + 8 * n * NORMAL_K))
        say("kernels", kernel="knn_dense", shape=f"{n}x{n}", k=NORMAL_K, idx_equal=True,
            ms=f"{k6[label]['ms']:.4f}", plain_ms=f"{k6[label]['plain_ms']:.4f}",
            bound_ms=f"{k6[label]['bound_ms']:.4f}")
    idx_k6_horse = ik
    # k = 32 (the longest list) at cow, and a lattice of exactly equal
    # distances: the 16^3 integer sites, each twice, queried at the sites
    # moved by seeded half steps, where the lowest index must win every tie.
    lat_q, lat_p = tied_lattice(seed + 6)
    for label, q, pts, k in (("cow_k32", cow_ref, cow_ref, 32),
                             ("lattice", lat_q, lat_p, NORMAL_K)):
        dk, ik = knn_dense.knn_dense(q, pts, k)
        dp, ip = knn_dense.knn_dense_plain(q, pts, k)
        require(torch.equal(ik, ip) and torch.equal(dk, dp), f"K6 {label}: differs from plain")
        n, m = q.shape[0], pts.shape[0]
        b = bound(PAIR_OPS * n * m, 12 * (n + m) + 8 * n * k)
        say("kernels", kernel="knn_dense", case=label, shape=f"{n}x{m}", k=k, equal_plain=True,
            ties_share=f"{float((dk[:, 1:] == dk[:, :-1]).double().mean()):.4f}",
            ms=f"{cuda_ms(lambda: knn_dense.knn_dense(q, pts, k), 20):.4f}",
            plain_ms=f"{cuda_ms(lambda: knn_dense.knn_dense_plain(q, pts, k), 5):.4f}",
            bound_ms=f"{b[0]:.4f}")
    # the record's numbers are at the main path's shape: cow's normals
    record["knn_dense"] = dict(k6["cow"], max_abs_err=max(v["max_abs_err"] for v in k6.values()))

    # K7: the horse normals' two launches (seed, exact pass with the seed's
    # k-th distance as each point's bound) on the tables knn_grid builds,
    # and the exact pass on a capacity-1 table (every tile past it folds all
    # tiles), each against its plain version; the whole path must equal K6
    # on the same cloud (the JAX contract knn_grid == knn_pallas).
    kgrid = nn_grid.build_model_grid(horse_ref, target_tile=256)  # the normals' tiles
    q7, _, _, tn7, _ = _prepare_scene(horse_ref, 64)
    q7 = q7.contiguous()
    k7 = k7_launches(q7, kgrid, tn7, 32, cap1=True)
    k7_err = max(v["max_abs_err"] for v in k7.values())
    main7 = [k7["seed"], k7["exact"]]
    idx_k7 = knn_indices(horse_ref, NORMAL_K, method="grid")
    require(torch.equal(idx_k7, idx_k6_horse), "K7: horse neighbours differ from K6")
    record["knn_grid"] = entry(k7_err, sum(v["ms"] for v in main7),
                               sum(v["plain_ms"] for v in main7),
                               bound(sum(v["ops"] for v in main7),
                                     sum(v["bytes"] for v in main7)))
    say("kernels", kernel="knn_grid", shape="48485x48485", k=NORMAL_K, equal_to_knn_dense=True,
        ms=f"{record['knn_grid']['ms']:.4f}", bound_ms=f"{record['knn_grid']['bound_ms']:.4f}")

    # K6 and K7 at k = 64, lists of two slots a lane: the neighbours FPFH
    # fetches.  K6 on bun000 subsampled to at most 4,096 rows as
    # global_register subsamples it, and on the tied lattice; K7's seed and
    # exact launches on horse (fpfh_features' grid path, tiles of 256 and
    # 64); each exactly equal to its plain version, and the K7 path to K6.
    bun = torch.tensor(_load("bun000.txt"), **f32)
    bun_sub = bun[::-(-bun.shape[0] // 4096)].contiguous()
    for label, q, pts in (("bunny_fpfh", bun_sub, bun_sub), ("lattice", lat_q, lat_p)):
        before = _build.LAUNCHES["knn_dense"]
        dk, ik = knn_dense.knn_dense(q, pts, FPFH_K)
        launches = _build.LAUNCHES["knn_dense"] - before
        dp, ip = knn_dense.knn_dense_plain(q, pts, FPFH_K)
        require(torch.equal(ik, ip) and torch.equal(dk, dp),
                f"K6 {label} k {FPFH_K}: differs from plain")
        n, m = q.shape[0], pts.shape[0]
        b = bound(PAIR_OPS * n * m, 12 * (n + m) + 8 * n * FPFH_K)
        say("kernels", kernel="knn_dense", case=f"{label}_k{FPFH_K}", shape=f"{n}x{m}",
            k=FPFH_K, launches=launches, equal_plain=True,
            ties_share=f"{float((dk[:, 1:] == dk[:, :-1]).double().mean()):.4f}",
            ms=f"{cuda_ms(lambda: knn_dense.knn_dense(q, pts, FPFH_K), 20):.4f}",
            plain_ms=f"{cuda_ms(lambda: knn_dense.knn_dense_plain(q, pts, FPFH_K), 5):.4f}",
            bound_ms=f"{b[0]:.4f}", bound_by=b[1])
    k7_long = k7_launches(q7, kgrid, tn7, 32, k=FPFH_K)
    idx_long = knn_indices(horse_ref, FPFH_K, method="grid")
    d6, i6 = knn_dense.knn_dense(horse_ref, horse_ref, FPFH_K)
    require(torch.equal(idx_long, i6), f"K7 k {FPFH_K}: horse neighbours differ from K6")
    b = bound(sum(v["ops"] for v in k7_long.values() if "ops" in v),
              sum(v["bytes"] for v in k7_long.values() if "bytes" in v))
    say("kernels", kernel="knn_grid", case=f"horse_k{FPFH_K}", shape="48485x48485", k=FPFH_K,
        equal_to_knn_dense=True, ms=f"{k7_long['seed']['ms'] + k7_long['exact']['ms']:.4f}",
        plain_ms=f"{k7_long['seed']['plain_ms'] + k7_long['exact']['plain_ms']:.4f}",
        k6_ms=f"{cuda_ms(lambda: knn_dense.knn_dense(horse_ref, horse_ref, FPFH_K), 5):.4f}",
        bound_ms=f"{b[0]:.4f}", bound_by=b[1])

    # K8: K1's shapes (cow 2,903^2, the grid seed 49,152 x 3,031); indices
    # equal to K1's and to the plain version's, three launches alike and
    # the merge workspace clean after each, with K1's time beside and both
    # kernels' device microseconds a call.
    k8 = {}
    ws_keys, ws_counts = nn_dense.chunked_workspace(dev)
    for label, s, m in (("cow", cow_tr1, cow_ref), ("horse_seed", p0, sub)):
        require(nn_dense.chunked_workspace(s.device)[0] is ws_keys,
                f"K8 {label}: the workspace checked is not the one the launches use")
        ik = nn_dense.nn_chunked(s, m)
        require(torch.equal(ik, nn_dense.nn_chunked_plain(s, m)),
                f"K8 {label}: indices differ from plain")
        require(torch.equal(ik, nn_dense.nn_dense(s, m)), f"K8 {label}: indices differ from K1")
        for _ in range(3):
            require(torch.equal(nn_dense.nn_chunked(s, m), ik), f"K8 {label}: launches differ")
            require(bool((ws_keys == -1).all()) and not bool(ws_counts.any()),
                    f"K8 {label}: the workspace is not clean after a launch")
        k8[label] = (cuda_ms(lambda: nn_dense.nn_chunked(s, m), 20),
                     cuda_ms(lambda: nn_dense.nn_chunked_plain(s, m), 5),
                     cuda_ms(lambda: nn_dense.nn_dense(s, m), 20))
        n, m_rows = s.shape[0], m.shape[0]
        chunk = nn_dense.chunked_chunk_rows(n, m_rows)
        say("kernels", kernel="nn_chunked", shape=f"{n}x{m_rows}",
            chunks=-(-m_rows // chunk), chunk_rows=chunk,
            idx_equal_plain=True, idx_equal_k1=True, workspace_clean=True,
            ms=f"{k8[label][0]:.4f}",
            device_us=f"{device_us(lambda: nn_dense.nn_chunked(s, m), ('nn_chunked',)):.2f}",
            plain_ms=f"{k8[label][1]:.4f}", k1_ms=f"{k8[label][2]:.4f}",
            k1_device_us=f"{device_us(lambda: nn_dense.nn_dense(s, m), K1_NAMES):.2f}",
            bound_ms=f"{bound(PAIR_OPS * n * m_rows, 12 * n + 12 * m_rows + 4 * n)[0]:.4f}")
    n, m = p0.shape[0], sub.shape[0]
    record["nn_chunked"] = entry(0.0, *k8["horse_seed"][:2],
                                 bound(PAIR_OPS * n * m, 12 * n + 12 * m + 4 * n))

    # K9: cow (tr1 onto ref) and horse 48,485^2 (tr1 onto ref), centred as
    # closest_point_indices_bf16 centres them, held to its plain version by
    # hold_k9; certified rows equal K1 on the same clouds.  Neither
    # certifies a row (their extent is far above their spacing), so a
    # jittered 4^3 lattice with 8,192 scene points beside its sites, where
    # the margins exceed the bf16 band, holds the certificate itself.
    rng = np.random.default_rng(seed + 9)
    sites = np.stack(np.meshgrid(*[np.arange(4.0)] * 3), -1).reshape(-1, 3)
    lat_m = torch.tensor(sites + 0.01 * rng.standard_normal(sites.shape), **f32)
    lat_s = torch.tensor(sites[rng.integers(0, len(sites), 8192)]
                         + 0.02 * rng.standard_normal((8192, 3)), **f32)
    k9 = {}
    for label, s, m in (("cow", cow_tr1, cow_ref), ("horse", horse_tr1, horse_ref),
                        ("lattice", lat_s, lat_m)):
        c = m.mean(0)
        sc, mc = (s - c).contiguous(), (m - c).contiguous()
        outs = nn_bf16.nn_bf16(sc, mc)
        held = hold_k9(label, sc, mc, outs)
        idx, dex, cert = nn_bf16.closest_point_indices_bf16(s, m)
        require(torch.equal(idx, outs[0]), f"K9 {label}: entry point differs from the kernel")
        require(label != "lattice" or float(cert.double().mean()) > 0.5,
                f"K9 lattice: only {int(cert.sum())} of {cert.numel()} rows certified")
        heavy = s.shape[0] > 10_000
        ms = cuda_ms(lambda: nn_bf16.nn_bf16(sc, mc), 5 if heavy else 20)
        plain_ms = cuda_ms(lambda: nn_bf16.nn_bf16_plain(sc, mc), 2 if heavy else 5, warmup=1)
        # The least time for the function: the cross term as a bf16
        # product on the tensor cores (K padded to 16: 32 operations a
        # pair) while the float32 units add the norm and make the fold's
        # two compares (3 a pair), or the bytes, whichever takes longest.
        # The all-float32 form (8 operations a pair) is printed beside it.
        n, m_rows = s.shape[0], m.shape[0]
        pairs, io_bytes = n * m_rows, 12 * n + 12 * m_rows + 16 * n
        tc_ms = BF16_PAIR_OPS * pairs / PEAK_BF16 * 1e3
        f32_ms = BF16_F32_PAIR_OPS * pairs / PEAK_FLOPS * 1e3
        k9[label] = entry(held["max_abs_err"], ms, plain_ms,
                          bf16_bound(pairs, io_bytes))
        chunks, _, scratch = nn_bf16.plan(n, m_rows)
        say("kernels", kernel="nn_bf16", shape=f"{n}x{m_rows}", chunks=chunks,
            partial_triples_bytes=chunks * n * 12, scratch_bytes=scratch,
            outputs_equal_plain=held["equal"],
            best_bit_equal_share=f"{held['best_share']:.6f}",
            idx_equal_plain_share=f"{held['idx_share']:.6f}", delta=f"{held['delta']:.3e}",
            max_abs_err=f"{held['max_abs_err']:.3e}",
            certified_share=f"{float(cert.double().mean()):.4f}",
            idx_equal_k1_share=f"{held['k1_share']:.4f}",
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{k9[label]['bound_ms']:.6f}",
            tensor_core_product_ms=f"{tc_ms:.6f}", float32_add_compares_ms=f"{f32_ms:.6f}",
            all_float32_bound_ms=f"{bound(PAIR_OPS * pairs, io_bytes)[0]:.6f}")
    record["nn_bf16"] = k9["cow"]  # the main path's shape: the bf16 runs on cow
    phase_pair_axis(seed)


def _cow_pairs(seed: int, n_pairs: int):
    """(models, scenes) float32 ndarrays: cow_ref, and cow_ref moved by
    ``n_pairs`` seeded similarities (the slam phase's batched cow)."""
    import numpy as np

    rng = np.random.default_rng(seed + 10)
    cow = _load("cow_ref.txt").astype(np.float32)
    scenes = []
    for _ in range(n_pairs):
        R, sc, t = _similarity_np(rng, 8.0)
        scenes.append((sc * cow @ R.T + t).astype(np.float32))
    return np.repeat(cow[None], n_pairs, 0), np.stack(scenes)


def _bunny_batch():
    """The bunny chain's batch as ``register_chain_batched`` hands it to the
    K1 + K2 path: 4 pairs of the five scans bucketed to 40,960 rows,
    replica-filled, on the card; and the true counts."""
    import numpy as np
    import torch

    from icp_tpu_torch.engine.batched import _bucket_prologue, batch_pairs

    clouds = [_load(f"{v}.txt").astype(np.float32) for v in BUNNY]
    models, scenes, m_ns, s_ns = batch_pairs([(clouds[i], clouds[i + 1])
                                              for i in range(len(clouds) - 1)])
    dev = torch.device("cuda")
    models, scenes, _ = _bucket_prologue(
        torch.tensor(models, device=dev), torch.tensor(scenes, device=dev),
        torch.tensor(s_ns, device=dev).long(), torch.tensor(m_ns, device=dev).long())
    return models.contiguous(), scenes.contiguous(), m_ns, s_ns


def phase_pair_axis(seed: int) -> None:
    """The pair axis of K1, K3, K2, K5 and K9 (one launch for B pairs, the
    counterpart of JAX's vmap over a pallas_call), each at the batched
    paths' shapes: every pair bit-equal to its own single-pair launch on the
    same inputs and to (or, K3's float64 sums, within 1e-8 of; K9, as
    ``hold_k9`` holds it) the plain version, with the batched launch's and
    a single pair's CUDA-event medians, device microseconds and the batch's
    bound."""
    import numpy as np
    import torch

    from icp_tpu_torch.kernels import icp_fused, nn_dense, qcp
    from icp_tpu_torch.ops.alignment import compute_alignment_stats

    dev = torch.device("cuda")

    # K1 on the bunny chain's batch: 4 x 40,960 rows, 6.7 G pairs a launch;
    # every row against the plain version and against four single launches.
    models, scenes, _, _ = _bunny_batch()
    b, n, m = scenes.shape[0], scenes.shape[1], models.shape[1]
    before = _build_launches("nn_dense")
    idx = nn_dense.nn_dense_batched(scenes, models)
    require(_build_launches("nn_dense") == before + 1, "K1 pair axis: not one launch")
    require(torch.equal(idx, nn_dense.nn_dense_batched_plain(scenes, models)),
            "K1 pair axis: indices differ from plain")
    singles = [nn_dense.nn_dense(scenes[k], models[k]) for k in range(b)]
    require(all(torch.equal(idx[k], singles[k]) for k in range(b)),
            "K1 pair axis: a pair differs from its own launch")
    ms = cuda_ms(lambda: nn_dense.nn_dense_batched(scenes, models), 10)
    one_ms = cuda_ms(lambda: nn_dense.nn_dense(scenes[0], models[0]), 10)
    plain_ms = cuda_ms(lambda: nn_dense.nn_dense_batched_plain(scenes, models), 2, warmup=1)
    bd = bound(PAIR_OPS * b * n * m, 12 * b * (n + m) + 4 * b * n)
    say("kernels", kernel="nn_dense", pair_axis=b, shape=f"{b}x{n}x{m}", pairs_a_launch=b * n * m,
        chunk_rows=nn_dense.chunk_rows(n, m, pairs=b), idx_equal_plain=True,
        idx_equal_single_launches=True, ms=f"{ms:.4f}",
        device_us=f"{device_us(lambda: nn_dense.nn_dense_batched(scenes, models), K1_NAMES, 5):.2f}",
        single_pair_ms=f"{one_ms:.4f}", single_pairs_ms=f"{b * one_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bd[0]:.4f}", bound_by=bd[1])

    # K3 at B = 8 and 32 on cow-size pairs, from the identity: three
    # launches, each pair's state, control, errors and rows bit-equal to
    # its own launch after each, the workspace clean, the state within
    # 1e-8 of the plain version.
    for b in (8, 32):
        ms_, sc_ = _cow_pairs(seed, b)
        mods, scs = torch.tensor(ms_, device=dev), torch.tensor(sc_, device=dev)
        prep = icp_fused.prepare_fused_inputs(scs, mods)
        st, ctl, errs = qcp.identity_state(dev, b), qcp.new_loop_control(4, dev, b), \
            qcp.new_err_buffer(4, dev, b)
        ones = [(icp_fused.prepare_fused_inputs(scs[k], mods[k]), qcp.identity_state(dev),
                 qcp.new_loop_control(4, dev), qcp.new_err_buffer(4, dev)) for k in range(b)]
        pst, pctl, perrs = st.clone(), ctl.clone(), errs.clone()
        worst = 0.0
        for _ in range(3):
            icp_fused.fused_icp_step(prep, st, ctl, errs, threshold=1e-5)
            require(bool((prep.keys == -1).all()) and not bool(prep.counts.any()),
                    f"K3 pair axis B={b}: the workspace is not clean after a launch")
            for k, (one, s1, c1, e1) in enumerate(ones):
                icp_fused.fused_icp_step(one, s1, c1, e1, threshold=1e-5)
                require(torch.equal(st[k:k + 1], s1) and torch.equal(ctl[k], c1)
                        and same_nan(errs[k], e1) and torch.equal(prep.rows[k], one.rows),
                        f"K3 pair axis B={b}: pair {k} differs from its own launch")
            for k in range(b):
                one = icp_fused.FusedInputs(p0=prep.p0[k], mt=prep.mt[k])
                qcp.qcp_step_plain(icp_fused.fused_partials_plain(one, pst[k:k + 1]),
                                   pst[k:k + 1], pctl[k], perrs[k], threshold=1e-5)
            require(torch.equal(ctl, pctl), f"K3 pair axis B={b}: control differs from plain")
            worst = max(worst, max_abs(st, pst))
        require(worst <= 1e-8, f"K3 pair axis B={b}: state {worst:.3g} from plain")
        bench = (qcp.identity_state(dev, b), qcp.new_loop_control(1 << 20, dev, b),
                 qcp.new_err_buffer(1 << 20, dev, b))
        one_prep = ones[0][0]
        one_bench = (qcp.identity_state(dev), qcp.new_loop_control(1 << 20, dev),
                     qcp.new_err_buffer(1 << 20, dev))

        def launch(prep=prep, bench=bench):
            icp_fused.fused_icp_step(prep, *bench, threshold=-math.inf)

        def single(prep=one_prep, bench=one_bench):
            icp_fused.fused_icp_step(prep, *bench, threshold=-math.inf)

        def plain(prep=prep, bench=bench, b=b):
            st, ctl, errs = bench
            for k in range(b):
                one = icp_fused.FusedInputs(p0=prep.p0[k], mt=prep.mt[k])
                qcp.qcp_step_plain(icp_fused.fused_partials_plain(one, st[k:k + 1]),
                                   st[k:k + 1], ctl[k], errs[k], threshold=-math.inf)

        n = m = mods.shape[1]
        blocks = prep.rows.shape[1]
        bd = bound(b * fused_ops(n, m),
                   b * (12 * n + 16 * m + blocks * 18 * 8 + 2 * (32 * 8 + 12) + 8))
        ms = cuda_ms(launch, 30)
        say("kernels", kernel="icp_fused", pair_axis=b, shape=f"{b}x{n}x{m}",
            grid=f"{blocks}x{-(-m // icp_fused.chunk_rows(n, m, b))}x{b}",
            bit_equal_single_launches=True, workspace_clean=True,
            state_max_abs_err_plain=f"{worst:.3e}", ms=f"{ms:.4f}",
            device_us=f"{device_us(launch, ('icp_fused_kernel',)):.2f}",
            single_pair_ms=f"{cuda_ms(single, 30):.4f}",
            single_pair_device_us=f"{device_us(single, ('icp_fused_kernel',)):.2f}",
            plain_ms=f"{cuda_ms(plain, 2, warmup=1):.4f}", bound_ms=f"{bd[0]:.5f}",
            bound_by=bd[1])

    # K2 at B = 4 and 8: one row of seeded statistics a pair, from warm
    # states; each pair bit-equal to its own launch and to plain.
    rng = np.random.default_rng(seed + 12)
    for b in (4, 8):
        rows = []
        for _ in range(b):
            P = torch.tensor(rng.standard_normal((1000, 3)), dtype=torch.float64, device=dev)
            Y = 1.2 * P.roll(1, 1) + torch.tensor(rng.standard_normal(3), device=dev) \
                + 1e-3 * torch.tensor(rng.standard_normal((1000, 3)), device=dev)
            rows.append(qcp.pack_stats(compute_alignment_stats(P, Y)))
        parts = torch.stack(rows)
        st0 = qcp.identity_state(dev, b)
        outs = []
        for fn in (qcp.qcp_step, qcp.qcp_step_plain):
            st, ctl, errs = st0.clone(), qcp.new_loop_control(4, dev, b), \
                qcp.new_err_buffer(4, dev, b)
            fn(parts, st, ctl, errs, threshold=1e-5)
            outs.append((st, ctl, errs))
        (sk, ck, ek), (sp, cp, ep) = outs
        require(torch.equal(sk, sp) and torch.equal(ck, cp) and same_nan(ek, ep),
                f"K2 pair axis B={b}: differs from plain")
        for k in range(b):
            s1, c1, e1 = st0[k:k + 1].clone(), qcp.new_loop_control(4, dev), \
                qcp.new_err_buffer(4, dev)
            qcp.qcp_step(parts[k], s1, c1, e1, threshold=1e-5)
            require(torch.equal(sk[k:k + 1], s1) and torch.equal(ck[k], c1)
                    and same_nan(ek[k], e1), f"K2 pair axis B={b}: pair {k} differs")

        def k2(fn, parts=parts, b=b, single=False):
            st = qcp.identity_state(dev, 1 if single else b)
            ctl = qcp.new_loop_control(1 << 20, dev, None if single else b)
            errs = qcp.new_err_buffer(1 << 20, dev, None if single else b)
            p = parts[0] if single else parts
            return lambda: fn(p, st, ctl, errs, threshold=-math.inf)

        bd = bound(b * step_ops(1), nbytes(parts) + b * (2 * 32 * 8 + 2 * 4 * 4 + 8))
        say("kernels", kernel="qcp_step", pair_axis=b, rows=1, bit_equal_plain=True,
            bit_equal_single_launches=True, ms=f"{cuda_ms(k2(qcp.qcp_step), 50):.4f}",
            device_us=f"{device_us(k2(qcp.qcp_step), ('qcp_step_kernel',)):.2f}",
            single_pair_ms=f"{cuda_ms(k2(qcp.qcp_step, single=True), 50):.4f}",
            plain_ms=f"{cuda_ms(k2(qcp.qcp_step_plain), 5):.4f}", bound_ms=f"{bd[0]:.3g}",
            bound_by=bd[1])

    # K5 at B = 8 on float32 and float64 statistics: qcp_rotation_from on
    # (8, 3, 3) S and (8,) gp, gy; each pair bit-equal to its own launch
    # and to plain.
    b = 8
    S0 = torch.tensor(rng.standard_normal((b, 3, 3)), dtype=torch.float64, device=dev)
    g0 = torch.tensor(rng.uniform(0.5, 4.0, (2, b)), dtype=torch.float64, device=dev)
    for dt in (torch.float32, torch.float64):
        S, gp, gy = S0.to(dt), g0[0].to(dt), g0[1].to(dt)
        before = _build_launches("qcp_rotation")
        got = qcp.qcp_rotation_from(S, gp, gy)
        require(_build_launches("qcp_rotation") == before + 1, "K5 pair axis: not one launch")
        want = qcp.qcp_rotation_from_plain(S, gp, gy)
        require(all(torch.equal(a, c) for a, c in zip(got, want)),
                f"K5 pair axis {dt}: differs from plain")
        for k in range(b):
            one = qcp.qcp_rotation_from(S[k], gp[k], gy[k])
            require(all(torch.equal(a[k], c) for a, c in zip(got, one)),
                    f"K5 pair axis {dt}: pair {k} differs from its own launch")
        size = 4 if dt == torch.float32 else 8
        bd = bound(b * ROTATION_OPS, b * (11 * size + 16 * 8 + 9 * size))
        say("kernels", kernel="qcp_rotation", pair_axis=b, dtype=str(dt)[6:], bit_equal_plain=True,
            bit_equal_single_launches=True,
            ms=f"{cuda_ms(lambda: qcp.qcp_rotation_from(S, gp, gy), 50):.4f}",
            device_us=f"{device_us(lambda: qcp.qcp_rotation_from(S, gp, gy), ('qcp_rotation_kernel',)):.2f}",
            single_pair_ms=f"{cuda_ms(lambda: qcp.qcp_rotation_from(S[0], gp[0], gy[0]), 50):.4f}",
            plain_ms=f"{cuda_ms(lambda: qcp.qcp_rotation_from_plain(S, gp, gy), 5):.4f}",
            bound_ms=f"{bd[0]:.3g}", bound_by=bd[1])

    # K9 at B = 1, 4 and 8 on the cow pairs and on the bunny chain's batch
    # (4 x 40,960^2), on the clouds centred as the engine centres them: one
    # launch a call; each pair's four outputs bit-equal to its own
    # single-pair launch, and held to its plain version by hold_k9; the
    # entry point (per-pair centring, then one launch) equal to each pair's
    # nearest_indices_bf16.
    k9_pair_axis(seed)


K9_NAMES = ("nn_bf16_prep_kernel", "nn_bf16_fold_kernel")  # K9's kernels in a trace


def k9_pair_axis(seed: int) -> None:
    """K9's pair axis (``nn_bf16_batched``) at the batched paths' shapes:
    see ``phase_pair_axis``."""
    import torch

    from icp_tpu_torch.kernels import nn_bf16

    dev = torch.device("cuda")
    cases = []
    for b in (1, 4, 8):
        ms_, sc_ = _cow_pairs(seed, b)
        cases.append((f"cow_B{b}", torch.tensor(sc_, device=dev), torch.tensor(ms_, device=dev)))
    models, scenes, _, _ = _bunny_batch()
    cases.append(("bunny_batch", scenes, models))
    for label, scenes, models in cases:
        b, n, m = scenes.shape[0], scenes.shape[1], models.shape[1]
        centres = nn_bf16.bf16_centres(models)
        mean1_equal = torch.equal(models.mean(1), centres)  # the reduction not taken
        sc = (scenes - centres[:, None]).contiguous()
        mc = (models - centres[:, None]).contiguous()
        before = _build_launches("nn_bf16")
        outs = nn_bf16.nn_bf16_batched(sc, mc)
        require(_build_launches("nn_bf16") == before + 1, f"K9 pair axis {label}: not one launch")
        worst = 0.0
        for k in range(b):
            one = nn_bf16.nn_bf16(sc[k], mc[k])
            require(all(torch.equal(a[k], c) for a, c in zip(outs, one)),
                    f"K9 pair axis {label}: pair {k} differs from its own launch")
            worst = max(worst, hold_k9(f"{label} pair {k}", sc[k], mc[k],
                                       tuple(a[k] for a in outs))["max_abs_err"])
        idx = nn_bf16.nearest_indices_bf16_batched(scenes, models)
        require(all(torch.equal(idx[k], nn_bf16.nearest_indices_bf16(scenes[k].clone(),
                                                                     models[k].clone()))
                    for k in range(b)), f"K9 pair axis {label}: the entry point differs per pair")
        heavy = n > 10_000
        ms = cuda_ms(lambda: nn_bf16.nn_bf16_batched(sc, mc), 5 if heavy else 20)
        one_ms = cuda_ms(lambda: nn_bf16.nn_bf16(sc[0], mc[0]), 5 if heavy else 20)
        plain_ms = cuda_ms(lambda: nn_bf16.nn_bf16_batched_plain(sc, mc), 1 if heavy else 3,
                           warmup=1)
        # the bound of K9's row (phase_kernels), for B N M pairs
        pairs, io_bytes = b * n * m, b * (12 * n + 12 * m + 16 * n)
        bd = bf16_bound(pairs, io_bytes)
        chunks, _, scratch = nn_bf16.plan(n, m, dev.index, b)
        say("kernels", kernel="nn_bf16", pair_axis=b, case=label, shape=f"{b}x{n}x{m}",
            pairs_a_launch=pairs, chunks=chunks, partial_triples_bytes=b * chunks * n * 12,
            scratch_bytes=scratch, launches_a_call=1, bit_equal_single_launches=True,
            hold_k9_per_pair=True, max_abs_err=f"{worst:.3e}", entry_equal_single=True,
            batched_mean_bit_equal=mean1_equal,
            ms=f"{ms:.4f}",
            device_us=f"{device_us(lambda: nn_bf16.nn_bf16_batched(sc, mc), K9_NAMES, 5):.2f}",
            single_pair_ms=f"{one_ms:.4f}",
            single_pair_device_us=f"{device_us(lambda: nn_bf16.nn_bf16(sc[0], mc[0]), K9_NAMES, 5):.2f}",
            single_pairs_ms=f"{b * one_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{bd[0]:.6f}", bound_by=bd[1])


def _build_launches(name: str) -> int:
    from icp_tpu_torch.kernels import _build

    return _build.LAUNCHES[name]


def _golden(path):
    with open(path) as f:
        return [float(e) for _, e in _TRACE_RE.findall(f.read())]


def _run_cli(args: list[str]):
    """(exit code, trace, stderr, seconds, launches) of one CLI run on the
    card, the launch counts set to 0 just before it and read just after."""
    import torch

    from icp_tpu_torch.engine.cli import main as cli_main
    from icp_tpu_torch.kernels import _build

    _build.reset_counts()
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli_main([*args, "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    used = dict(_build.LAUNCHES)
    got = [float(e) for _, e in _TRACE_RE.findall(err.getvalue())]
    return rc, got, err.getvalue(), seconds, used


def _check_output(label, out_path, gold_path, atol):
    import numpy as np

    from icp_tpu_torch.io.csv import load_matrix

    with contextlib.redirect_stderr(io.StringIO()):
        out = load_matrix(out_path)
        gold = load_matrix(gold_path)
    require(out.shape == gold.shape and bool(np.isfinite(out).all()),
            f"cli {label}: output shape {out.shape}")
    off = float(np.abs(out - gold).max())
    # np.testing.assert_allclose's rule (rtol 1e-7): both clouds are
    # printed at 6 significant digits, a last-digit step above 1 is 1e-5
    require(bool(np.all(np.abs(out - gold) <= atol + 1e-7 * np.abs(gold))),
            f"cli {label}: output {off:.3g} from the reference")
    return off


def _check_trace(label, got, want, want_iters):
    require(len(got) == want_iters == len(want),
            f"cli {label}: {len(got)} iterations, reference {len(want)}")
    big = [(g, w) for g, w in zip(got, want) if w > 1e-6]
    worst = max(abs(g - w) / w for g, w in big)
    require(worst <= TRACE_RTOL, f"cli {label}: trace off by {worst:.3g} relative")
    return worst


def _add(total: dict, used: dict) -> None:
    for k, v in used.items():
        total[k] = total.get(k, 0) + v


def phase_cli(tmp: str) -> dict:
    """The main paths through the CLI and the entry points of K8 and K9;
    returns the launches of every run."""
    from icp_tpu_torch.engine.icp import _CHUNK  # iterations launched between flag reads

    total = {}
    for fixture, ref, scene, nb_iter, want_iters, atol, extra in CLI_CASES:
        label = fixture + ("_k5" if extra else "")
        out_path = os.path.join(tmp, f"{label}_output.txt")
        rc, got, err, seconds, used = _run_cli(
            [os.path.join(ROOT, "data", ref), os.path.join(ROOT, "data", scene), str(nb_iter),
             "--output", out_path, *extra])
        require(rc == 0, f"cli {label}: exit {rc}\n{err}")
        worst = _check_trace(label, got, _golden(os.path.join(FIXDIR, f"{fixture}_stderr.txt")),
                             want_iters)
        off = _check_output(label, out_path, os.path.join(FIXDIR, f"{fixture}_output.txt"), atol)
        if extra:
            require(used["qcp_rotation"] >= want_iters and used["qcp_step"] == 0,
                    f"cli {label}: K5 path not taken ({used})")
        elif fixture.startswith("cow"):  # one K3 launch an iteration, K2 inside it
            launched = min(nb_iter, -(-want_iters // _CHUNK) * _CHUNK)
            require(used["icp_fused"] == launched and used["qcp_step"] == 0,
                    f"cli {label}: fused path not taken ({used})")
        else:
            require(used["nn_grid"] >= want_iters and used["qcp_step"] >= want_iters
                    and used["nn_dense"] >= 1, f"cli {label}: grid path not taken ({used})")
        _add(total, used)
        say("cli", case=label, iters=len(got), trace_max_rel_err=f"{worst:.3e}",
            output_max_abs_err=f"{off:.3e}", seconds=f"{seconds:.3f}", launches=used)

    for engine, (folder, short, pairs) in PLANE_CASES.items():
        _add(total, _plane_engine_cli(tmp, engine, folder, short, pairs))
    _add(total, _chunked_entry())
    _k5_bcast_loop()
    _add(total, _mxu_entry())
    _add(total, _bf16_path())
    _full_float32_under_tf32(tmp)
    _fixed_mode_nan()
    return total


def _plane_engine_cli(tmp: str, engine: str, folder: str, short: str, pairs: dict) -> dict:
    """``--engine engine`` on the cow pairs against the JAX CLI's fixtures
    (dense: K6 normals, K1) and on horse_tr1 (grid: K7 normals, K4 with the
    normals payload) against the port's own dense path on the card."""
    import torch

    from icp_tpu_torch import ICPConfig
    from icp_tpu_torch.engine.plane import run_engine
    from icp_tpu_torch.io.csv import load_matrix
    from icp_tpu_torch.ops.normals import estimate_normals

    total = {}
    fixdir = os.path.join(FIXTURES, folder)
    clouds = 2 if engine in BOTH_NORMALS else 1  # clouds whose normals are estimated
    for fixture, want_iters in pairs.items():
        label = f"{short}_{fixture}"
        out_path = os.path.join(tmp, f"{label}_output.txt")
        rc, got, err, seconds, used = _run_cli(
            [os.path.join(ROOT, "data", "cow_ref.txt"), os.path.join(ROOT, "data", f"{fixture}.txt"),
             "30", "--engine", engine, "--output", out_path])
        require(rc == 0, f"cli {label}: exit {rc}\n{err}")
        worst = _check_trace(label, got, _golden(os.path.join(fixdir, f"{fixture}_stderr.txt")),
                             want_iters)
        off = _check_output(label, out_path, os.path.join(fixdir, f"{fixture}_output.txt"), 1e-5)
        require(used["knn_dense"] == clouds and used["nn_dense"] >= want_iters,
                f"cli {label}: dense {engine} path not taken ({used})")
        _add(total, used)
        say("cli", case=label, iters=len(got), trace_max_rel_err=f"{worst:.3e}",
            output_max_abs_err=f"{off:.3e}", seconds=f"{seconds:.3f}", launches=used)

    label = f"{short}_horse_tr1"
    out_path = os.path.join(tmp, f"{label}_output.txt")
    rc, got, err, seconds, used = _run_cli(
        [os.path.join(ROOT, "data", "horse_ref.txt"), os.path.join(ROOT, "data", "horse_tr1.txt"),
         "30", "--engine", engine, "--output", out_path])
    require(rc == 0, f"cli {label}: exit {rc}\n{err}")
    require(used["knn_grid"] == 2 * clouds and used["nn_grid"] >= len(got)
            and used["nn_dense"] >= 1, f"cli {label}: grid {engine} path not taken ({used})")
    _add(total, used)
    model = torch.tensor(_load("horse_ref.txt"), dtype=torch.float32, device="cuda")
    scene_t = torch.tensor(_load("horse_tr1.txt"), dtype=torch.float32, device="cuda")
    normals = estimate_normals(model, method="dense")
    scene_normals = estimate_normals(scene_t, method="dense") if clouds == 2 else None
    dense = run_engine(engine, model, scene_t, ICPConfig(max_iter=30, nn_method="pallas"),
                       model_normals=normals, scene_normals=scene_normals, trace=True)
    n_dense = int(dense.result.iters)
    require(len(got) == n_dense, f"cli {label}: {len(got)} iterations, dense path {n_dense}")
    with contextlib.redirect_stderr(io.StringIO()):
        out = load_matrix(out_path)
    off = float(abs(out - dense.result.points.cpu().numpy()).max())
    require(off <= 1e-5, f"cli {label}: output {off:.3g} from the dense path")
    dense_errs = dense.errs[:n_dense].tolist()
    worst = max((abs(g - w) / w for g, w in zip(got, dense_errs) if w > 1e-6), default=0.0)
    say("cli", case=label, path="grid", iters=len(got), dense_iters=n_dense,
        trace=",".join(f"{e:.6g}" for e in got), trace_max_rel_err_vs_dense=f"{worst:.3e}",
        output_max_abs_err_vs_dense=f"{off:.3e}", seconds=f"{seconds:.3f}", launches=used)
    return total


def _counted(fn):
    """(fn's result, launches) with the counts set to 0 just before it and
    read just after."""
    import torch

    from icp_tpu_torch.kernels import _build

    _build.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(_build.LAUNCHES)


def _chunked_entry() -> dict:
    """K8 through its entry point, ``closest_point_indices_dense(...,
    distance_impl="chunked")``, at K1's main-path shapes (cow, and the grid
    seed of horse), against K1 on the same clouds.  No engine takes K8, as
    no JAX engine takes the chunked form."""
    import torch

    from icp_tpu_torch.engine.grid import _prepare_scene
    from icp_tpu_torch.kernels.nn_dense import closest_point_indices_dense

    f32 = dict(dtype=torch.float32, device="cuda")
    horse_ref = torch.tensor(_load("horse_ref.txt"), **f32)
    cases = {"cow": (torch.tensor(_load("cow_tr1.txt"), **f32),
                     torch.tensor(_load("cow_ref.txt"), **f32)),
             "horse_seed": (_prepare_scene(torch.tensor(_load("horse_tr1.txt"), **f32), 256)[0],
                            horse_ref[::16])}
    want = {k: closest_point_indices_dense(s, m) for k, (s, m) in cases.items()}
    got, used = _counted(lambda: {k: closest_point_indices_dense(s, m, distance_impl="chunked")
                                  for k, (s, m) in cases.items()})
    for k in cases:
        require(torch.equal(got[k], want[k]), f"nn_chunked entry {k}: indices differ from K1")
    require(used["nn_chunked"] == len(cases) and used["nn_dense"] == 0,
            f"nn_chunked entry: K8 not taken ({used})")
    say("path", case="nn_chunked_entry", shapes="2903x2903,49152x3031", idx_equal_k1=True,
        launches=used)
    return used


def _k5_bcast_loop() -> None:
    """The ``qcp_fused`` step with the bcast NN (K5 each iteration) on
    cow_tr1: ms/iter over 100 iterations, its device launches an
    iteration, and one K5 launch an iteration."""
    import torch

    from icp_tpu_torch.engine.icp import icp_fixed_iters

    f32 = dict(dtype=torch.float32, device="cuda")
    model = torch.tensor(_load("cow_ref.txt"), **f32)
    scene = torch.tensor(_load("cow_tr1.txt"), **f32)

    def run(i):
        return float(icp_fixed_iters(model, scene, n_iters=i, solver="qcp_fused",
                                     nn_method="bcast").err)

    _, used = _counted(lambda: run(10))
    require(used["qcp_rotation"] == 10 and sum(used.values()) == 10,
            f"cow bcast qcp_fused: not one K5 launch an iteration ({used})")
    run(2)
    t1 = statistics.median(_wall(lambda: run(1)) for _ in range(3))
    t101 = statistics.median(_wall(lambda: run(101)) for _ in range(3))
    say("path", case="cow_bcast_qcp_fused", k5_launches_per_iter=1,
        device_launches_per_iter=f"{launches_per_iter(run):.2f}",
        ms_per_iter=f"{(t101 - t1) / 100 * 1e3:.4f}")


def _mxu_entry() -> dict:
    """K10 through its entry point, ``closest_point_indices_dense(...,
    distance_impl="mxu")``, at K1's main-path shapes (cow, and the grid seed
    of horse): equal to its plain version, beside K1.  No engine takes it,
    as no JAX engine takes the ``"mxu"`` form."""
    import torch

    from icp_tpu_torch.engine.grid import _prepare_scene
    from icp_tpu_torch.kernels.nn_dense import closest_point_indices_dense, nn_dense_plain

    f32 = dict(dtype=torch.float32, device="cuda")
    cases = {"cow": (torch.tensor(_load("cow_tr1.txt"), **f32),
                     torch.tensor(_load("cow_ref.txt"), **f32)),
             "horse_seed": (_prepare_scene(torch.tensor(_load("horse_tr1.txt"), **f32), 256)[0]
                            .contiguous(), torch.tensor(_load("horse_ref.txt"), **f32)[::16]
                            .contiguous())}
    k1 = {k: closest_point_indices_dense(s, m) for k, (s, m) in cases.items()}
    got, used = _counted(lambda: {k: closest_point_indices_dense(s, m, distance_impl="mxu")
                                  for k, (s, m) in cases.items()})
    for k, (s, m) in cases.items():
        require(torch.equal(got[k], nn_dense_plain(s, m, distance_impl="mxu")),
                f"nn_dense_mxu entry {k}: indices differ from plain")
    require(used["nn_dense_mxu"] == len(cases) and used["nn_dense"] == 0,
            f"nn_dense_mxu entry: K10 not taken ({used})")
    say("path", case="nn_dense_mxu_entry", shapes="2903x2903,49152x3031", idx_equal_plain=True,
        idx_equal_k1_share=",".join(f"{float((got[k] == k1[k]).double().mean()):.6f}"
                                    for k in cases), launches=used)
    return used


def _full_float32_under_tf32(tmp: str) -> None:
    """The caller's ``torch.set_float32_matmul_precision("high")`` (TF32 on
    the card) changes nothing inside the package: the cow_tr1 CLI case (7
    iterations) and an ``icp_symmetric`` cow_tr1 run (3) give the same
    iterations, trace and cloud as under ``"highest"``, and the caller's
    setting reads ``"high"`` afterwards."""
    import torch

    from icp_tpu_torch import ICPConfig, icp_symmetric

    f32 = dict(dtype=torch.float32, device="cuda")
    cow_ref = torch.tensor(_load("cow_ref.txt"), **f32)
    cow_tr1 = torch.tensor(_load("cow_tr1.txt"), **f32)
    runs = {}
    for prec in ("highest", "high"):
        out_path = os.path.join(tmp, f"tf32_{prec}_output.txt")
        torch.set_float32_matmul_precision(prec)
        try:
            rc, got, err, _, _ = _run_cli([os.path.join(ROOT, "data", "cow_ref.txt"),
                                           os.path.join(ROOT, "data", "cow_tr1.txt"), "10",
                                           "--output", out_path])
            sym = icp_symmetric(cow_ref, cow_tr1, ICPConfig(max_iter=30), trace=True)
            torch.cuda.synchronize()
            after = torch.get_float32_matmul_precision()
        finally:
            torch.set_float32_matmul_precision("highest")
        require(rc == 0 and after == prec, f"tf32 {prec}: exit {rc}, caller's setting {after}")
        with open(out_path) as f:
            cloud = f.read()
        runs[prec] = (_TRACE_RE.findall(err), cloud, sym)
    (t0, c0, s0), (t1, c1, s1) = runs["highest"], runs["high"]
    n0, n1 = int(s0.result.iters), int(s1.result.iters)
    require(len(t0) == len(t1) == 7 and t0 == t1 and c0 == c1,
            f"tf32: CLI cow_tr1 {len(t1)} iterations under high, {len(t0)} under highest")
    require(n0 == n1 == 3 and torch.equal(s0.errs[:n0], s1.errs[:n1])
            and torch.equal(s0.result.points, s1.result.points),
            f"tf32: icp_symmetric cow_tr1 {n1} iterations under high, {n0} under highest")
    say("repair", case="full_float32_under_high", cli_iters=len(t1), sym_iters=n1,
        trace_bit_equal=True, output_bit_equal=True, caller_setting_after="high")


def _fixed_mode_nan() -> None:
    """``icp_fixed_iters(n_iters=10)`` with one NaN coordinate runs all 10
    iterations on the fused path (10 K3 launches, no K2 launch) and on the
    grid path (K1 seed, K4, K2), as JAX's ``fori_loop``; the error is NaN."""
    import numpy as np

    from icp_tpu_torch.engine.icp import icp_fixed_iters

    model = _load("cow_ref.txt")
    scene = _load("cow_tr1.txt").copy()
    scene[5, 1] = np.nan
    for nn, kernel in (("pallas", "icp_fused"), ("grid", "nn_grid")):
        res, used = _counted(lambda: icp_fixed_iters(model, scene, n_iters=10, solver="qcp_fused",
                                                     nn_method=nn))
        iters, err = int(res.iters), float(res.err)
        k2 = 0 if kernel == "icp_fused" else 10  # the fused launch runs K2's step itself
        require(iters == 10 and math.isnan(err) and used["qcp_step"] == k2
                and used[kernel] == 10, f"fixed mode {nn}: {iters} iterations, err {err} ({used})")
        say("repair", case="fixed_iters_nan", path=nn, iters=iters, err=err, launches=used)


def surface(rng, n):
    """The curved surface of the symmetric engine's tests:
    z = 0.3 sin(2x) + 0.2 y^2 over [-1, 1]^2."""
    import numpy as np

    xy = rng.uniform(-1.0, 1.0, (n, 2))
    return np.column_stack([xy, 0.3 * np.sin(2.0 * xy[:, 0]) + 0.2 * xy[:, 1] ** 2])


def rigid(rng, angle):
    """A rotation by ``angle`` about a seeded axis and a seeded shift."""
    import numpy as np

    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)
    return R, rng.standard_normal(3) * 0.05


def _bf16_path() -> dict:
    """K9 through ``icp_symmetric`` with ``nn_method="bf16"``: on the seeded
    500-point surface (an exact transform) it must register; on cow_tr1 it
    may stall inside the bf16 band (the JAX package's behaviour too), and
    only a finite trace is required."""
    import numpy as np
    import torch

    from icp_tpu_torch import ICPConfig, closest_point_indices_bf16, icp_symmetric

    rng = np.random.default_rng(43)
    model = surface(rng, 500).astype(np.float32)
    R, t = rigid(rng, 0.1)
    scene = (model.astype(np.float64) @ R.T + t).astype(np.float32)
    m_t, s_t = (torch.tensor(a, device="cuda") for a in (model, scene))
    cfg = ICPConfig(max_iter=40, threshold=1e-10, nn_method="bf16", validate_inputs=False)
    res, used = _counted(lambda: icp_symmetric(m_t, s_t, cfg))
    iters = int(res.iters)
    steps = min(40, 8 * math.ceil(iters / 8))  # the gated loop launches whole chunks
    require(used["nn_bf16"] == steps and used["knn_dense"] == 2 and used["nn_dense"] == 0,
            f"bf16 surface: K9 not launched once an iteration ({used}, {iters} iterations)")
    dev = float(np.median(np.linalg.norm(res.points.cpu().numpy() - model, axis=1)))
    require(dev < 1e-2, f"bf16 surface: median deviation {dev:.3g}")
    say("path", case="bf16_symmetric_surface", points=500, iters=iters,
        median_deviation=f"{dev:.3e}", err=f"{float(res.err):.3e}", launches=used)
    total = dict(used)

    f32 = dict(dtype=torch.float32, device="cuda")
    cow_ref = torch.tensor(_load("cow_ref.txt"), **f32)
    cow_tr1 = torch.tensor(_load("cow_tr1.txt"), **f32)
    tr, used = _counted(lambda: icp_symmetric(cow_ref, cow_tr1,
                                              ICPConfig(max_iter=30, nn_method="bf16"),
                                              trace=True))
    iters = int(tr.result.iters)
    errs = tr.errs[:iters].tolist()
    require(iters >= 1 and all(map(math.isfinite, errs)), f"bf16 cow: trace {errs}")
    require(used["nn_bf16"] >= iters, f"bf16 cow: K9 not taken ({used})")
    _add(total, used)
    first = float(closest_point_indices_bf16(cow_tr1, cow_ref)[2].double().mean())
    last = float(closest_point_indices_bf16(tr.result.points, cow_ref)[2].double().mean())
    say("path", case="bf16_symmetric_cow_tr1", iters=iters,
        trace=",".join(f"{e:.6g}" for e in errs), certified_share_first=f"{first:.4f}",
        certified_share_last=f"{last:.4f}", launches=used)
    return total


# the CLI with --trim 0.1 against the JAX CLI's runs: engine -> {pair:
# iterations} (tests/fixtures/torch_trim/; point-to-point is JAX's float64
# run, which the card's float32 cloud with float64 sums reproduces)
TRIM_CASES = {"point_to_point": {"cow_tr1": 8, "cow_tr2": 17},
              "point_to_plane": {"cow_tr1": 4}, "symmetric": {"cow_tr1": 4},
              "gicp": {"cow_tr1": 3}}


def _launched(iters: int, bound: int) -> int:
    """Iterations a chunked loop launches for ``iters`` run of ``bound``."""
    from icp_tpu_torch.engine.icp import _CHUNK

    return min(bound, -(-iters // _CHUNK) * _CHUNK)


def _features_trim(tmp: str) -> dict:
    """Trim: the CLI on the cow pairs against the JAX fixtures (the
    pipeline, K1 + K2, no K3 launch), horse_tr1 on the grid path (K4 + K2)
    against the port's dense trimmed path on the card."""
    import torch

    from icp_tpu_torch import ICPConfig, icp

    total = {}
    fixdir = os.path.join(FIXTURES, "torch_trim")
    for engine, pairs in TRIM_CASES.items():
        for pair, want_iters in pairs.items():
            label = f"trim_{engine}_{pair}"
            out_path = os.path.join(tmp, f"{label}_output.txt")
            rc, got, err, seconds, used = _run_cli(
                [os.path.join(ROOT, "data", "cow_ref.txt"),
                 os.path.join(ROOT, "data", f"{pair}.txt"), "30", "--engine", engine,
                 "--trim", "0.1", "--output", out_path])
            require(rc == 0, f"features {label}: exit {rc}\n{err}")
            worst = _check_trace(label, got, _golden(os.path.join(
                fixdir, f"{engine}_{pair}_stderr.txt")), want_iters)
            off = _check_output(label, out_path, os.path.join(
                fixdir, f"{engine}_{pair}_output.txt"), 1e-5)
            launched = _launched(want_iters, 30)
            if engine == "point_to_point":
                require(used["nn_dense"] == used["qcp_step"] == launched
                        and used["icp_fused"] == 0, f"features {label}: not the pipeline ({used})")
            else:
                require(used["nn_dense"] == launched, f"features {label}: K1 not taken ({used})")
            _add(total, used)
            say("features", case=label, iters=len(got), launched=launched,
                trace_max_rel_err=f"{worst:.3e}", output_max_abs_err=f"{off:.3e}",
                seconds=f"{seconds:.3f}", launches=used)

    f32 = dict(dtype=torch.float32, device="cuda")
    model = torch.tensor(_load("horse_ref.txt"), **f32)
    scene = torch.tensor(_load("horse_tr1.txt"), **f32)
    runs = {}
    for nn in ("grid", "pallas"):
        cfg = ICPConfig(max_iter=30, trim_fraction=0.1, nn_method=nn)
        runs[nn], used = _counted(lambda: icp(model, scene, cfg, trace=True))
        _add(total, used)
        n = int(runs[nn].result.iters)
        kernel = "nn_grid" if nn == "grid" else "nn_dense"
        require(used[kernel] == used["qcp_step"] == _launched(n, 30) and used["icp_fused"] == 0,
                f"features trim horse {nn}: path not taken ({used})")
        runs[nn] = (runs[nn], used)
    (g, gu), (d, du) = runs["grid"], runs["pallas"]
    n = int(g.result.iters)
    off = max_abs(g.result.points, d.result.points)
    require(n == int(d.result.iters) and off <= 1e-5,
            f"features trim horse: grid {n} iterations, dense {int(d.result.iters)}, "
            f"points {off:.3g} apart")
    say("features", case="trim_horse_tr1_grid_vs_dense", iters=n,
        trace=",".join(f"{e:.6g}" for e in g.errs[:n].tolist()),
        points_max_abs_err=f"{off:.3e}", grid_launches=gu, dense_launches=du)
    return total


def _features_bucket() -> dict:
    """Bucket padding: horse through ``pad_to_bucket`` (quantum 4,096:
    49,152 rows) against the unpadded run, point-to-point and
    point-to-plane; the normals of the sentinel-padded cow (K6) and horse
    (K7) against the unpadded normals on the real rows, with K7's tables."""
    import torch

    from icp_tpu_torch import ICPConfig, icp, icp_point_to_plane
    from icp_tpu_torch.engine.grid import _prepare_scene
    from icp_tpu_torch.kernels import knn_grid, nn_grid
    from icp_tpu_torch.ops.normals import estimate_normals
    from icp_tpu_torch.ops.padding import pad_to_bucket

    total = {}
    horse_ref, horse_tr1 = _load("horse_ref.txt"), _load("horse_tr1.txt")
    m_pad, m_n = pad_to_bucket(horse_ref, quantum=4096)
    s_pad, s_n = pad_to_bucket(horse_tr1, quantum=4096)
    require(m_pad.shape[0] == s_pad.shape[0] == 49152, f"bucket: {m_pad.shape}, {s_pad.shape}")
    for engine, fn, tol in (("point_to_point", icp, 1e-6),
                            ("point_to_plane", icp_point_to_plane, 1e-5)):
        cfg = ICPConfig(max_iter=30)
        exact, used_e = _counted(lambda: fn(horse_ref, horse_tr1, cfg))
        padded, used_p = _counted(lambda: fn(m_pad, s_pad, cfg, scene_n=s_n, model_n=m_n))
        _add(total, used_p)
        n = int(exact.iters)
        off = max_abs(padded.points[:s_n], exact.points)
        require(int(padded.iters) == n and off <= tol,
                f"features bucket {engine}: {int(padded.iters)} iterations, exact {n}, "
                f"points {off:.3g} apart")
        require(used_p["nn_grid"] >= n and used_p["nn_grid"] == used_e["nn_grid"],
                f"features bucket {engine}: not the grid path ({used_p})")
        say("features", case=f"bucket_horse_{engine}", rows=m_pad.shape[0], real=s_n,
            iters=n, points_max_abs_err=f"{off:.3e}", tol=tol, launches=used_p)

    for label, cloud, method in (("cow", _load("cow_ref.txt"), "dense"),
                                 ("horse", horse_ref, "grid")):
        padded, n = pad_to_bucket(cloud, quantum=4096)
        want = estimate_normals(cloud)
        got, used = _counted(lambda: estimate_normals(padded))
        _add(total, used)
        # K6 once; K7 twice (the seed and the exact pass)
        kernel, calls = ("knn_dense", 1) if method == "dense" else ("knn_grid", 2)
        require(used[kernel] == calls,
                f"features bucket normals {label}: {kernel} not taken ({used})")
        off = max_abs(got[:n], want)
        require(off <= 1e-6 and bool(torch.isfinite(got).all()),
                f"features bucket normals {label}: {off:.3g} from the unpadded normals")
        extra = {}
        if method == "grid":  # K7's exact table on the padded and the unpadded cloud
            for tag, pts in (("padded", padded), ("unpadded", cloud)):
                q = torch.tensor(pts, dtype=torch.float32, device="cuda")
                kgrid = nn_grid.build_model_grid(q, target_tile=256)
                qs, _, _, tn, _ = _prepare_scene(q, 64)
                qs = qs.contiguous()
                bd2 = nn_grid.tile_box_dists(qs, kgrid, scene_tile=tn)
                d_seed, _ = knn_grid.knn_worklist(*knn_grid.seed_table(bd2, NORMAL_K,
                                                                       kgrid.model_tile),
                                                  qs, kgrid.tiles, tn, NORMAL_K)
                cand, counts = knn_grid.cull_table(bd2, d_seed[:, NORMAL_K - 1], tn,
                                                   min(32, bd2.shape[1]))
                shape = k7_table(cand, counts, kgrid.tiles.shape[0], kgrid.model_tile, tn)
                extra[f"{tag}_past_capacity"] = shape["fallback_tiles"]
                extra[f"{tag}_folded_pairs"] = shape["folded_pairs"]
        say("features", case=f"bucket_normals_{label}", rows=padded.shape[0], real=n,
            kernel=kernel, normals_max_abs_err=f"{off:.3e}", **extra, launches=used)
    return total


def _features_guard() -> dict:
    """The device guard: a NaN coordinate stops cow_tr1 at iteration 1 on
    the fused path (K3) and on the pipeline (K1 + K2); a clean guarded run
    is bit-equal to the unguarded one with the same launches; K2's and K3's
    status words bit-equal to their plain versions."""
    import numpy as np
    import torch

    from icp_tpu_torch import ICPConfig, icp
    from icp_tpu_torch.engine.icp import ICPGuardError
    from icp_tpu_torch.kernels import icp_fused, qcp
    from icp_tpu_torch.ops.alignment import compute_alignment_stats

    total = {}
    ref, tr1 = _load("cow_ref.txt"), _load("cow_tr1.txt")
    bad = tr1.copy()
    bad[7, 1] = np.nan
    for path, trim, kernel in (("fused", 0.0, "icp_fused"), ("pipeline", 0.1, "qcp_step")):
        cfg = ICPConfig(max_iter=30, trim_fraction=trim)
        plain, used_u = _counted(lambda: icp(ref, tr1, cfg))
        guarded, used_g = _counted(lambda: icp(ref, tr1, cfg, guard="device"))
        same = (int(plain.iters) == int(guarded.iters)
                and torch.equal(plain.points, guarded.points)
                and torch.equal(plain.err, guarded.err))
        require(same and used_u == used_g,
                f"features guard {path}: the clean guarded run differs ({used_u}, {used_g})")
        msg = None
        from icp_tpu_torch.kernels import _build

        _build.reset_counts()
        try:
            icp(ref, bad, cfg, guard="device")
        except ICPGuardError as e:
            msg = str(e)
        torch.cuda.synchronize()
        used = dict(_build.LAUNCHES)
        _add(total, used)
        require(msg is not None and "non-finite error at iteration 1 " in msg,
                f"features guard {path}: {msg}")
        require(used[kernel] == _launched(1, 30), f"features guard {path}: ({used})")
        say("features", case=f"guard_nan_{path}", raised="ICPGuardError",
            message=repr(msg[:48]), clean_bit_equal=True, clean_launches=used_g, launches=used)

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    rows = []
    for sigma in (0.05, 0.03, 0.6, 0.01):  # the error jumps > 100x at step 2
        P = torch.tensor(rng.standard_normal((200, 3)), device=dev)
        Y = P + sigma * torch.tensor(rng.standard_normal((200, 3)), device=dev)
        rows.append(qcp.pack_stats(compute_alignment_stats(P, Y)).contiguous())
    nan_row = rows[1].clone()
    nan_row[0, 3] = float("nan")
    for label, seq, want in (("diverged", rows, qcp.GUARD_DIVERGED),
                             ("nonfinite", [rows[0], nan_row], qcp.GUARD_NONFINITE)):
        outs = []
        for fn in (qcp.qcp_step, qcp.qcp_step_plain):
            st, ctl, errs = qcp.identity_state(dev), qcp.new_loop_control(8, dev), \
                qcp.new_err_buffer(8, dev)
            words = []
            for r in seq:
                fn(r, st, ctl, errs, with_scale=False, err_factor=1.0, threshold=-math.inf,
                   guard=True)
                words.append(ctl.tolist())
            outs.append((st, words, errs))
        (sk, wk, ek), (sp, wp, ep) = outs
        equal = wk == wp and same_nan(sk, sp) and same_nan(ek, ep)
        stop = 2 if label == "diverged" else 1
        require(equal and wk[stop][1:] == [1, 8, want] and wk[stop][0] == stop + 1,
                f"features K2 status {label}: kernel {wk}, plain {wp}")
        say("features", case=f"k2_status_{label}", steps=len(seq), ctl=wk[-1],
            bit_equal_plain=True)

    prep = icp_fused.prepare_fused_inputs(torch.tensor(bad, device=dev),
                                          torch.tensor(ref, device=dev))
    st, ctl, errs = qcp.identity_state(dev), qcp.new_loop_control(4, dev), \
        qcp.new_err_buffer(4, dev)
    icp_fused.fused_icp_step(prep, st, ctl, errs, threshold=1e-5, guard=True)
    pst, pctl, perrs = qcp.identity_state(dev), qcp.new_loop_control(4, dev), \
        qcp.new_err_buffer(4, dev)
    qcp.qcp_step_plain(prep.rows, pst, pctl, perrs, threshold=1e-5, guard=True)
    require(ctl.tolist() == pctl.tolist() == [1, 1, 4, qcp.GUARD_NONFINITE]
            and same_nan(st, pst) and same_nan(errs, perrs),
            f"features K3 status: kernel {ctl.tolist()}, plain on its rows {pctl.tolist()}")
    say("features", case="k3_status_nonfinite", ctl=ctl.tolist(), bit_equal_plain=True)
    return total


def _features_resume(tmp: str) -> dict:
    """``icp_resumable`` on cow_tr1 in chunks of 3, killed after one chunk
    and resumed: bit-equal to the uninterrupted chunked run."""
    import torch

    from icp_tpu_torch import ICPConfig
    from icp_tpu_torch.engine.icp import icp_resumable

    ref, tr1 = _load("cow_ref.txt"), _load("cow_tr1.txt")
    full, used = _counted(lambda: icp_resumable(
        ref, tr1, ICPConfig(max_iter=30), checkpoint_path=os.path.join(tmp, "full.npz"),
        checkpoint_every=3))
    killed = os.path.join(tmp, "killed.npz")
    icp_resumable(ref, tr1, ICPConfig(max_iter=3), checkpoint_path=killed, checkpoint_every=3)
    resumed = icp_resumable(ref, tr1, ICPConfig(max_iter=30), checkpoint_path=killed,
                            checkpoint_every=3, resume=True)
    same = (int(full.iters) == int(resumed.iters) and torch.equal(full.points, resumed.points)
            and all(torch.equal(a, b) for a, b in zip(full.transform, resumed.transform))
            and float(full.err) == float(resumed.err))
    require(same and int(full.iters) > 3 and used["icp_fused"] >= int(full.iters),
            f"features resume: {int(full.iters)} and {int(resumed.iters)} iterations ({used})")
    say("features", case="resume_cow_tr1", chunk=3, iters=int(full.iters), bit_equal=True,
        err=f"{float(full.err):.6e}", launches=used)
    return used


def _features_metrics(tmp: str) -> dict:
    """The CLI's ``--metrics --metrics-ops`` on cow (K3's path; K1 timed)
    and horse (the grid path; K4 timed).  The op timer's calls (warm-up and
    timed, after the loop) are counted apart and left out of the launches
    the run returns, which are the loop's."""
    from unittest import mock

    from icp_tpu_torch.kernels import _build
    from icp_tpu_torch.utils import metrics

    timer = {}
    op_times = metrics._op_times

    def counted_op_times(*args, **kwargs):
        before = dict(_build.LAUNCHES)
        out = op_times(*args, **kwargs)
        _add(timer, {k: v - before[k] for k, v in _build.LAUNCHES.items()})
        return out

    total = {}
    for label, ref, scene, nn, kernels in (
            ("cow", "cow_ref.txt", "cow_tr1.txt", "pallas", ("icp_fused",)),
            ("horse", "horse_ref.txt", "horse_tr1.txt", "grid", ("nn_grid", "qcp_step"))):
        mpath = os.path.join(tmp, f"metrics_{label}.json")
        timer.clear()
        with mock.patch.object(metrics, "_op_times", counted_op_times):
            rc, got, err, seconds, used = _run_cli(
                [os.path.join(ROOT, "data", ref), os.path.join(ROOT, "data", scene), "30",
                 "--metrics", mpath, "--metrics-ops", "--output",
                 os.path.join(tmp, f"metrics_{label}_output.txt")])
        require(rc == 0, f"features metrics {label}: exit {rc}\n{err}")
        with open(mpath) as f:
            rec = json.load(f)
        require(rec["iters"] == len(got) == len(rec["errs"]) and rec["nn_method"] == nn
                and rec["backend"] == "cuda" and rec["correspondence_us"] > 0
                and rec["alignment_us"] > 0, f"features metrics {label}: {rec}")
        loop = {k: v - timer.get(k, 0) for k, v in used.items()}
        require(all(loop[k] == _launched(rec["iters"], 30) for k in kernels)
                and loop["qcp_rotation"] == 0 and timer.get("nn_dense" if nn == "pallas" else "nn_grid", 0) > 0,
                f"features metrics {label}: loop {loop}, timer {timer}")
        _add(total, loop)
        say("features", case=f"metrics_{label}", iters=rec["iters"], nn_method=nn,
            solver=rec["solver"], wall_s=f"{rec['wall_s']:.4f}",
            correspondence_us=f"{rec['correspondence_us']:.2f}",
            alignment_us=f"{rec['alignment_us']:.2f}", launches=loop,
            timer_launches={k: v for k, v in timer.items() if v})
    return total


def phase_features(tmp: str) -> dict:
    """Trim, bucket padding, the device guard, resume and run metrics;
    returns the launches of every run."""
    total = {}
    for fn in (lambda: _features_trim(tmp), _features_bucket, _features_guard,
               lambda: _features_resume(tmp), lambda: _features_metrics(tmp)):
        _add(total, fn())
    return total


def _wall(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_loop_times():
    """ms/iter and set-up ms of the four engines on cow (dense) and horse
    (grid); the plane engines get their normals (the model's timed) before
    the loop."""
    import torch

    from icp_tpu_torch import ICPConfig
    from icp_tpu_torch.engine.icp import icp_fixed_iters
    from icp_tpu_torch.engine.plane import run_engine
    from icp_tpu_torch.ops.normals import estimate_normals
    from icp_tpu_torch.ops.padding import pad_to_bucket

    for label, ref, scene, nn in (("cow", "cow_ref.txt", "cow_tr1.txt", "pallas"),
                                  ("horse", "horse_ref.txt", "horse_tr1.txt", "grid")):
        model = torch.tensor(_load(ref), dtype=torch.float32, device="cuda")
        sc = torch.tensor(_load(scene), dtype=torch.float32, device="cuda")

        def run(k):
            return _wall(lambda: float(icp_fixed_iters(model, sc, n_iters=k, solver="qcp_fused",
                                                       nn_method=nn).err))

        run(2)
        t1 = statistics.median(run(1) for _ in range(3))
        t21 = statistics.median(run(21) for _ in range(3))
        say("loop", case=label, engine="point_to_point", path=nn,
            ms_per_iter=f"{(t21 - t1) / 20 * 1e3:.4f}", setup_plus_one_iter_ms=f"{t1 * 1e3:.3f}")
        # the new cells: trimmed (the pipeline on cow), and horse bucketed
        cells = {"trim": (model, sc, dict(trim_fraction=0.1))}
        if label == "horse":
            m_pad, m_n = pad_to_bucket(_load(ref), quantum=4096)
            s_pad, s_n = pad_to_bucket(_load(scene), quantum=4096)
            cells["bucket"] = (torch.tensor(m_pad, device="cuda"),
                               torch.tensor(s_pad, device="cuda"),
                               dict(scene_n=s_n, model_n=m_n))
        for cell, (m, s, kw) in cells.items():
            def run_cell(k):
                return _wall(lambda: float(icp_fixed_iters(m, s, n_iters=k, solver="qcp_fused",
                                                           nn_method=nn, **kw).err))

            run_cell(2)
            t1 = statistics.median(run_cell(1) for _ in range(3))
            t21 = statistics.median(run_cell(21) for _ in range(3))
            say("loop", case=label, engine="point_to_point", path=nn, cell=cell,
                rows=s.shape[0], ms_per_iter=f"{(t21 - t1) / 20 * 1e3:.4f}",
                setup_plus_one_iter_ms=f"{t1 * 1e3:.3f}")

        method = "dense" if nn == "pallas" else "grid"
        estimate_normals(model, method=method)
        t_n = statistics.median(_wall(lambda: estimate_normals(model, method=method))
                                for _ in range(3))
        normals = estimate_normals(model, method=method)
        scene_normals = estimate_normals(sc, method=method)

        for engine in PLANE_CASES:
            def run_pl(k):
                cfg = ICPConfig(max_iter=k, threshold=-math.inf, nn_method=nn)
                return _wall(lambda: float(run_engine(engine, model, sc, cfg,
                                                      model_normals=normals,
                                                      scene_normals=scene_normals).err))

            run_pl(2)
            t1 = statistics.median(run_pl(1) for _ in range(3))
            t21 = statistics.median(run_pl(21) for _ in range(3))
            say("loop", case=label, engine=engine, path=nn, normals=method,
                normals_ms=f"{t_n * 1e3:.3f}", ms_per_iter=f"{(t21 - t1) / 20 * 1e3:.4f}",
                setup_plus_one_iter_ms=f"{t1 * 1e3:.3f}")


def scale_pair(seed: int, n: int = 1_000_000):
    """(model, scene, s_true) on the card: horse upsampled to ``n`` points
    with seeded jitter; the scene is another jittered draw moved by a known
    similarity (4 degrees about a seeded axis, scale 1.03, a small shift)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    horse = _load("horse_ref.txt")
    base = np.tile(horse, (-(-n // horse.shape[0]), 1))[:n]
    jitter = 2e-4  # ~1/3 of horse's median point spacing (7e-4)
    model_np = base + jitter * rng.standard_normal(base.shape)
    ang = np.deg2rad(4.0)
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K
    s_true, t_true = 1.03, np.array([0.004, -0.003, 0.002])
    scene_np = s_true * (base + jitter * rng.standard_normal(base.shape)) @ R.T + t_true
    f32 = dict(dtype=torch.float32, device="cuda")
    return torch.tensor(model_np, **f32), torch.tensor(scene_np, **f32), s_true


def grid_loop_states(model, scene, iterations: int):
    """(model grid, scene tile, [(p, u)] of the first ``iterations``
    point-to-point grid iterations): the kd-sorted scene and its bounds as
    K4's table sees them, the loop's steps taken with the float64 Horn sums
    and the eigh solve."""
    import torch

    from icp_tpu_torch.engine.grid import _prepare_scene
    from icp_tpu_torch.kernels import nn_grid
    from icp_tpu_torch.ops.alignment import Similarity, alignment_from_stats, compute_alignment_stats
    from icp_tpu_torch.ops.transform import apply_similarity

    grid = nn_grid.build_model_grid(model, target_tile=1024)
    p, w, _, tn, _ = _prepare_scene(scene, 256)
    u = nn_grid.bound_from_indices(p, grid, nn_grid.initial_bound_indices(p, model))
    states = [(p, u)]
    while len(states) < iterations:
        _, y, _, _, _ = nn_grid.closest_point_indices_pruned(p, grid, u, scene_tile=tn)
        stats = compute_alignment_stats(p, y, acc_dtype=torch.float64, weights=w)
        sim = alignment_from_stats(stats, solver="eigh", with_scale=True)
        p = apply_similarity(p, Similarity(*(v.to(torch.float32) for v in sim)))
        u = nn_grid.next_bound(y, p)
        states.append((p, u))
    return grid, tn, states


def phase_scale(seed: int):
    import numpy as np
    import torch

    from icp_tpu_torch import ICPConfig
    from icp_tpu_torch.engine.grid import _prepare_scene
    from icp_tpu_torch.engine.icp import icp_fixed_iters
    from icp_tpu_torch.engine.plane import run_engine
    from icp_tpu_torch.kernels import knn_dense, nn_dense, nn_grid
    from icp_tpu_torch.ops.normals import (
        estimate_normals,
        knn_indices,
        normals_from_neighbor_indices,
    )

    n = 1_000_000
    model, scene, s_true = scale_pair(seed, n)
    rng = np.random.default_rng(seed + 1)

    # K4 on two 1M tables: the first iteration's and the third's (the
    # loop's steady state).  Each is held against K1 brute force on 65,536
    # seeded scene rows and against the plain version on 64 seeded scene
    # tiles and up to 4 tiles that fold all tiles, then timed.
    grid, tn, states = grid_loop_states(model, scene, 3)
    nj, tm = grid.tiles.shape[0], grid.model_tile
    rows = torch.tensor(np.sort(rng.choice(states[0][0].shape[0], 65536, replace=False)),
                        device="cuda")
    over_first = None
    for label, (p, u) in (("first", states[0]), ("third", states[2])):
        idx, y, _, d2, over = nn_grid.closest_point_indices_pruned(p, grid, u, scene_tile=tn)
        over_first = bool(over) if over_first is None else over_first
        idx_bf, d2_bf = nn_dense.nn_dense(p[rows].contiguous(), model, with_dist=True)
        mism = int((idx[rows] != idx_bf).sum())
        require(mism == 0, f"scale: {mism} of 65536 {label}-iteration matches differ "
                "from brute force")
        require(bool(torch.equal(d2[rows], d2_bf)), f"scale: {label}-iteration distances differ")
        require(bool(torch.equal(y[rows], model[idx_bf.long()])),
                f"scale: {label}-iteration matched points are not the winners")
        cand, counts, _ = nn_grid.candidates(p, u, grid, scene_tile=tn, cap=16)
        args = (cand, counts, p, grid.tiles, tn)
        outs = nn_grid.nn_grid(*args, kd_row=grid.kd_row)
        ni = cand.shape[0]
        fall = torch.nonzero(counts > 16).flatten()[:4]
        pick = torch.tensor(rng.choice(ni, 64, replace=False), device="cuda")
        sel = torch.unique(torch.cat([pick, fall]))
        srows = (sel[:, None] * tn + torch.arange(tn, device="cuda")).flatten()
        sub = nn_grid.nn_grid_plain(cand[sel].contiguous(), counts[sel].contiguous(),
                                    p[srows].contiguous(), grid.tiles, tn, kd_row=grid.kd_row)
        for name, a, b in zip(("d2", "idx", "y"), outs, sub):
            require(torch.equal(a[srows], b), f"scale: K4 {label} {name} differs from plain")
        ms = cuda_ms(lambda: nn_grid.nn_grid(*args, kd_row=grid.kd_row), 10)
        shape = k4_table(cand, counts, nj, tm, tn)
        b = bound(PAIR_OPS * shape["folded_pairs"], nbytes(cand, counts, p, grid.tiles)
                  + p.shape[0] * (4 + 4 + 12))
        say("scale", kernel="nn_grid", table=label, tiles=f"{ni}x{nj}", **shape,
            brute_force_rows=65536, plain_tiles=int(sel.numel()), equal_plain=True,
            ms=f"{ms:.4f}", bound_ms=f"{b[0]:.4f}", bound_by=b[1])
    # K1 on the 1M bound seed (the kd-sorted scene x every 16th model
    # point), held against its plain version on 65,536 seeded scene rows.
    p = states[0][0]
    sub = model[::16].contiguous()
    ik, dk = nn_dense.nn_dense(p, sub, with_dist=True)
    ip, dp = nn_dense.nn_dense_plain(p[rows].contiguous(), sub, with_dist=True)
    require(torch.equal(ik[rows], ip) and torch.equal(dk[rows], dp),
            "scale: K1 seed differs from plain")
    ms = cuda_ms(lambda: nn_dense.nn_dense(p, sub), 5)
    b = bound(PAIR_OPS * p.shape[0] * sub.shape[0], 12 * (p.shape[0] + sub.shape[0]) + 4 * p.shape[0])
    say("scale", kernel="nn_dense", shape=f"{p.shape[0]}x{sub.shape[0]}",
        chunk_rows=nn_dense.chunk_rows(p.shape[0], sub.shape[0]), plain_rows=65536,
        equal_plain=True, ms=f"{ms:.4f}",
        device_us=f"{device_us(lambda: nn_dense.nn_dense(p, sub), K1_NAMES, 3):.1f}",
        bound_ms=f"{b[0]:.4f}", bound_by=b[1])
    # K8 on the same seed: indices equal to K1's on every row and to its
    # plain version on the same 65,536 rows, timed beside K1.
    i8 = nn_dense.nn_chunked(p, sub)
    require(torch.equal(i8, ik), "scale: K8 seed differs from K1")
    require(torch.equal(i8[rows], nn_dense.nn_chunked_plain(p[rows].contiguous(), sub)),
            "scale: K8 seed differs from plain")
    say("scale", kernel="nn_chunked", shape=f"{p.shape[0]}x{sub.shape[0]}",
        chunk_rows=nn_dense.chunked_chunk_rows(p.shape[0], sub.shape[0]), plain_rows=65536,
        idx_equal_k1=True, equal_plain=True, ms=f"{cuda_ms(lambda: nn_dense.nn_chunked(p, sub), 5):.4f}",
        device_us=f"{device_us(lambda: nn_dense.nn_chunked(p, sub), ('nn_chunked',), 3):.1f}",
        k1_ms=f"{ms:.4f}", bound_ms=f"{b[0]:.4f}", bound_by=b[1])
    del grid, states, p, u, idx, y, d2, ik, dk, i8

    def run(k, trim=0.0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = icp_fixed_iters(model, scene, n_iters=k, solver="qcp_fused", nn_method="grid",
                              trim_fraction=trim)
        err = float(res.err)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, res, err

    run(1)
    t1, _, err1 = run(1)
    t10, res, err10 = run(10)
    pts = res.points
    require(pts.shape == (n, 3) and bool(torch.isfinite(pts).all()), "scale: bad output cloud")
    require(math.isfinite(err10) and err10 < err1, f"scale: error {err1} -> {err10}")
    say("scale", points=f"{n}x{n}", first_iter_checked=65536, first_iter_overflow=over_first,
        err_iter1=f"{err1:.6e}", err_iter10=f"{err10:.6e}",
        s=f"{float(res.transform.s):.6f}", s_inverse_true=f"{1 / s_true:.6f}",
        ms_per_iter=f"{(t10 - t1) / 9 * 1e3:.3f}", ten_iters_s=f"{t10:.3f}")
    del res, pts
    # the same loop trimmed: the quantile of K4's distances each iteration
    run(1, 0.1)
    tt1, _, terr1 = run(1, 0.1)
    tt10, res, terr10 = run(10, 0.1)
    require(bool(torch.isfinite(res.points).all()) and math.isfinite(terr10) and terr10 < terr1,
            f"scale trim: error {terr1} -> {terr10}")
    say("features", case="scale_trim", points=f"{n}x{n}", trim=0.1,
        err_iter1=f"{terr1:.6e}", err_iter10=f"{terr10:.6e}",
        ms_per_iter=f"{(tt10 - tt1) / 9 * 1e3:.3f}",
        untrimmed_ms_per_iter=f"{(t10 - t1) / 9 * 1e3:.3f}")
    del res

    # K7 on the 1M model's seed and exact tables (the normals' tiles), each
    # against its plain version on 64 seeded query tiles and up to 4 tiles
    # past the capacity.
    kgrid = nn_grid.build_model_grid(model, target_tile=256)
    q7, _, _, tn7, _ = _prepare_scene(model, 64)

    def sample(cand, counts):
        fall = torch.nonzero(counts > cand.shape[1]).flatten()[:4]
        pick = torch.tensor(rng.choice(cand.shape[0], 64, replace=False), device="cuda")
        return torch.unique(torch.cat([pick, fall]))

    k7_launches(q7.contiguous(), kgrid, tn7, 32, sample=sample, phase="scale")
    del kgrid, q7

    # K7 normals of the 1M model; their neighbours against K6 on seeded rows.
    torch.cuda.reset_peak_memory_stats()
    holder = {}
    t_knn = _wall(lambda: holder.update(idx=knn_indices(model, NORMAL_K, method="grid")))
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    nbr = holder["idx"]
    rows = torch.tensor(np.sort(rng.choice(n, 16384, replace=False)), device="cuda")
    _, idx_k6 = knn_dense.knn_dense(model[rows].contiguous(), model, NORMAL_K)
    mism = int((nbr[rows] != idx_k6).sum())
    require(mism == 0, f"scale: {mism} K7 neighbours of 16384 rows differ from K6")
    t_pca = _wall(lambda: holder.update(normals=normals_from_neighbor_indices(model, nbr)))
    normals = holder["normals"]
    require(bool(torch.isfinite(normals).all()), "scale: non-finite normals")
    say("scale", normals_points=n, k=NORMAL_K, knn_grid_ms=f"{t_knn * 1e3:.3f}",
        pca_ms=f"{t_pca * 1e3:.3f}", knn_peak_gib=f"{peak_gb:.2f}", rows_checked=16384)

    t_sn = _wall(lambda: holder.update(scene_normals=estimate_normals(scene, method="grid")))
    scene_normals = holder["scene_normals"]
    require(bool(torch.isfinite(scene_normals).all()), "scale: non-finite scene normals")
    say("scale", scene_normals_points=n, method="grid", ms=f"{t_sn * 1e3:.3f}")

    for engine in PLANE_CASES:
        def run_pl(k):
            cfg = ICPConfig(max_iter=k, threshold=-math.inf, nn_method="grid")
            holder.clear()
            t = _wall(lambda: holder.update(tr=run_engine(
                engine, model, scene, cfg, model_normals=normals, scene_normals=scene_normals,
                trace=True)))
            return t, holder["tr"]

        run_pl(1)
        t1, _ = run_pl(1)
        t10, tr = run_pl(10)
        errs = tr.errs.tolist()
        require(int(tr.result.iters) == 10 and all(map(math.isfinite, errs)),
                f"scale: {engine} errors {errs}")
        require(errs[9] < errs[0], f"scale: {engine} error {errs[0]} -> {errs[9]}")
        require(bool(torch.isfinite(tr.result.points).all()), f"scale: bad {engine} cloud")
        say("scale", engine=engine, points=f"{n}x{n}", err_iter1=f"{errs[0]:.6e}",
            err_iter10=f"{errs[9]:.6e}", ms_per_iter=f"{(t10 - t1) / 9 * 1e3:.3f}",
            ten_iters_s=f"{t10:.3f}")
        del tr
        holder.clear()


def _similarity_np(rng, max_deg: float):
    """(R, s, t): a rotation of up to ``max_deg`` degrees about a seeded axis,
    a scale within 3% of 1 and a small shift."""
    import numpy as np

    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    ang = np.deg2rad(rng.uniform(0.5, max_deg))
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K
    return R, rng.uniform(0.97, 1.03), 0.05 * rng.standard_normal(3)


# icp_batched's cases on cow: (path, pairs) -> the launches each takes,
# every one n_iters times (the pair axis: once an iteration for all pairs)
SLAM_BATCHED = {("bcast_eigh", 8): (), ("bcast_eigh", 32): (),
                ("pallas_qcp_fused", 1): ("icp_fused",), ("pallas_qcp_fused", 8): ("icp_fused",),
                ("pallas_qcp_fused", 32): ("icp_fused",),
                ("bcast_qcp_fused", 8): ("qcp_rotation",), ("pallas_eigh", 8): ("nn_dense",),
                ("bf16_eigh", 8): ("nn_bf16",), ("bf16_eigh", 32): ("nn_bf16",),
                ("bf16_qcp_fused", 8): ("nn_bf16", "qcp_rotation"),
                ("bf16_qcp_fused", 32): ("nn_bf16", "qcp_rotation")}


def _lockstep(models, scenes, n_iters: int, kw: dict, s_ns=None, m_ns=None):
    """Each iteration of ``icp_batched`` against each pair's own
    ``icp_fixed_iters`` from the same state: from the batched points after k
    iterations, one batched iteration (the k + 1-st of the batched run, bit
    for bit) and, per pair, one iteration of its own (its true rows); with
    bf16, each pair's K9 indices from that state equal to its single-pair
    entry point's.  Returns (the stepped points (B, N, 3), the worst points
    difference, the worst error excess over rtol 1e-4) over every pair and
    iteration."""
    import torch

    from icp_tpu_torch.engine.batched import _bucket_prologue, icp_batched
    from icp_tpu_torch.engine.icp import icp_fixed_iters
    from icp_tpu_torch.kernels import nn_bf16

    dev = torch.device("cuda")
    counts = [(None if s_ns is None else int(s_ns[b]), None if m_ns is None else int(m_ns[b]))
              for b in range(len(models))]
    p, worst_p, worst_e = torch.tensor(scenes, device=dev), 0.0, 0.0
    padded = _bucket_prologue(torch.tensor(models, device=dev), p,
                              None if s_ns is None else torch.tensor(s_ns, device=dev).long(),
                              None if m_ns is None else torch.tensor(m_ns, device=dev).long())[0]
    for _ in range(n_iters):
        if kw["nn_method"] == "bf16":
            idx = nn_bf16.nearest_indices_bf16_batched(p, padded)
            require(all(torch.equal(idx[b], nn_bf16.nearest_indices_bf16(p[b].clone(),
                                                                          padded[b].clone()))
                        for b in range(p.shape[0])), "lockstep: K9's indices differ per pair")
        step = icp_batched(models, p, n_iters=1, scene_ns=s_ns, model_ns=m_ns, **kw)
        for b, (sn, mn) in enumerate(counts):
            one = icp_fixed_iters(models[b], p[b], n_iters=1, scene_n=sn, model_n=mn, **kw)
            worst_p = max(worst_p, max_abs(step.points[b, :sn], one.points[:sn]))
            worst_e = max(worst_e, abs(float(step.err[b]) - float(one.err))
                          - 1e-4 * abs(float(one.err)))
        p = step.points
    return p, worst_p, worst_e


def _slam_batched(seed: int) -> dict:
    """``icp_batched`` on cow-size pairs (cow_ref and cow_ref moved by seeded
    similarities), 10 fixed iterations, each case of ``SLAM_BATCHED``: the
    kernel path (``pallas``/``qcp_fused``: K3, one launch an iteration for
    all the pairs) bit-equal to each pair's own ``icp_fixed_iters``; the
    paths with the pair axis in tensor ops (bcast/eigh, bcast/qcp_fused
    with K5, pallas/eigh with K1, bf16 with K9 and eigh or qcp_fused, each
    kernel once an iteration) held to it within 1e-5 (points) and rtol
    1e-4 / atol 1e-7 (errors) at B = 8.  At B = 32 two runs of 10
    iterations drift apart: the batch's float32 sums, solves and apply
    round otherwise than one pair's, and a pair that has not converged
    (with the exact NN too: bcast/eigh) or K9's index, which may be any
    candidate inside its bf16 band, turns an ulp into a step of its own;
    so there, and on every bf16 case, each iteration is held, from the
    same state, to each pair's own iteration within the same bounds
    (``_lockstep``), and the runs' distance is printed
    (``pairs_beyond_1e5``).  The bf16 runs stall inside the bf16 band
    (errors ~5.6e-3), so only the exact paths must converge."""
    import torch

    from icp_tpu_torch.engine.batched import icp_batched
    from icp_tpu_torch.engine.icp import icp_fixed_iters

    n_iters = 10
    launches = {}
    for (path, n_pairs), kernels in SLAM_BATCHED.items():
        models, scenes = _cow_pairs(seed, n_pairs)
        nn, solver = path.split("_", 1)
        kw = dict(solver=solver, nn_method=nn)
        res, used = _counted(lambda: icp_batched(models, scenes, n_iters=n_iters, **kw))
        seconds = statistics.median(
            _wall(lambda: icp_batched(models, scenes, n_iters=n_iters, **kw)) for _ in range(3))
        worst_p = worst_e = 0.0
        beyond = 0
        exact = path == "pallas_qcp_fused"
        for b in range(n_pairs):
            one = icp_fixed_iters(models[b], scenes[b], n_iters=n_iters, **kw)
            if exact:
                require(torch.equal(res.points[b], one.points) and torch.equal(res.err[b], one.err)
                        and all(torch.equal(a[b], c) for a, c in zip(res.transform, one.transform)),
                        f"slam batched {path} B={n_pairs}: pair {b} differs from its own run")
            # float32 sums over a pair axis against one pair's: errors
            # within rtol 1e-4 / atol 1e-7 and points within 1e-5 (JAX's
            # batched test)
            dp = max_abs(res.points[b], one.points)
            de = abs(float(res.err[b]) - float(one.err)) - 1e-4 * abs(float(one.err))
            beyond += dp > 1e-5 or de > 1e-7
            worst_p, worst_e = max(worst_p, dp), max(worst_e, de)
        step = {}
        if exact or n_pairs <= 8:
            require(worst_p <= 1e-5 and worst_e <= 1e-7,
                    f"slam batched {path}: {worst_p:.3g} / {worst_e:.3g} from the per-pair runs")
        if not exact and (n_pairs > 8 or nn == "bf16"):
            stepped, sp, se = _lockstep(models, scenes, n_iters, kw)
            require(torch.equal(stepped, res.points), f"slam batched {path} B={n_pairs}: the "
                                                      f"stepped run is not the batched run")
            require(sp <= 1e-5 and se <= 1e-7,
                    f"slam batched {path} B={n_pairs}: an iteration {sp:.3g} / {se:.3g} from "
                    f"the pair's own")
            step = dict(lockstep_points_max_abs_err=f"{sp:.3e}",
                        lockstep_err_excess_over_rtol=f"{se:.3e}")
        want = {k: n_iters for k in kernels}
        require({k: v for k, v in used.items() if v} == want,
                f"slam batched {path} B={n_pairs}: launches {used}, want {want}")
        _add(launches, used)
        # the first 8 moves (up to 8 degrees) all converge in 10
        # iterations on the exact paths; of the 32, some need more (their
        # runs, not the batch)
        err = res.err.double()
        require(bool(torch.isfinite(err).all())
                and (nn == "bf16" or float(err[:8].max()) < 1e-4),
                f"slam batched {path}: errors {err.tolist()}")
        say("slam", case="icp_batched", path=path, pairs=n_pairs, rows=models.shape[1],
            iters=n_iters, points_max_abs_err_vs_pair=f"{worst_p:.3e}",
            err_excess_over_rtol_vs_pair=f"{worst_e:.3e}", pairs_beyond_1e5=beyond, **step,
            bit_equal=exact, err_max=f"{float(err.max()):.3e}",
            pairs_err_below_1e4=int((err < 1e-4).sum()), ms=f"{seconds * 1e3:.3f}",
            ms_per_pair=f"{seconds * 1e3 / n_pairs:.4f}",
            ms_per_pair_iter=f"{seconds * 1e3 / n_pairs / n_iters:.5f}", launches=used)
    return launches


def _slam_chain_batched() -> dict:
    """``register_chain_batched`` on the five bunny scans at full resolution
    (unequal counts bucketed to 40,960 rows), 10 fixed iterations: the
    default path (bcast/eigh, one batch) and ``bf16``/eigh (one K9 launch
    an iteration for all the pairs; also each iteration within 1e-5 of the
    pair's own from the same state, ``_lockstep``) held to each padded
    pair's ``icp_fixed_iters`` within 1e-4; ``pallas``/``qcp_fused`` (masked: one
    K1 and one K2 launch an iteration for all the pairs) held to it within
    1e-6 (points) and 1e-9 (transform), the float64 Horn sums over a pair
    axis adding in another order; and ``"auto"`` (the grid path pair by
    pair: K1's seed, K4 and K2 each iteration)."""
    import numpy as np
    import torch

    from icp_tpu_torch.engine.batched import batch_pairs, register_chain_batched
    from icp_tpu_torch.engine.icp import icp_fixed_iters
    from icp_tpu_torch.ops.padding import auto_quantum, bucket_size, pad_to_bucket

    clouds = [_load(f"{v}.txt").astype(np.float32) for v in BUNNY]
    n_pairs, n_iters = len(clouds) - 1, 10
    pad = max(len(c) for c in clouds)  # batch_pairs' bucket
    pad = bucket_size(pad, auto_quantum(pad))
    launches = {}
    for path, kw in (("bcast_eigh", {}), ("pallas_qcp_fused",
                                          dict(solver="qcp_fused", nn_method="pallas")),
                     ("bf16_eigh", dict(nn_method="bf16")),
                     ("auto", dict(solver="auto", nn_method="auto"))):
        out, used = _counted(lambda: register_chain_batched(clouds, n_iters=n_iters, **kw))
        seconds = _wall(lambda: register_chain_batched(clouds, n_iters=n_iters, **kw))
        require(len(out) == n_pairs and all(
            r.points.shape == (len(c), 3) and bool(torch.isfinite(r.points).all())
            for r, c in zip(out, clouds[1:])), f"slam chain {path}: bad results")
        worst = worst_p = 0.0
        if path != "auto":
            for b in range(n_pairs):
                mp, mn = pad_to_bucket(clouds[b], n_pad=pad)
                sp, sn = pad_to_bucket(clouds[b + 1], n_pad=pad)
                one = icp_fixed_iters(mp, sp, n_iters=n_iters, scene_n=sn, model_n=mn, **kw)
                worst = max(worst, *(max_abs(a, c) for a, c in zip(out[b].transform,
                                                                   one.transform)))
                worst_p = max(worst_p, max_abs(out[b].points, one.points[:sn]))
            held = (1e-9, 1e-6) if path == "pallas_qcp_fused" else (1e-4, 1e-4)
            require(worst <= held[0] and worst_p <= held[1],
                    f"slam chain {path}: {worst:.3g} / {worst_p:.3g} from the per-pair runs")
        if path == "pallas_qcp_fused":
            require({k: v for k, v in used.items() if v} == {"nn_dense": n_iters,
                                                              "qcp_step": n_iters},
                    f"slam chain {path}: launches {used}")
        step = {}
        if path == "bf16_eigh":
            require({k: v for k, v in used.items() if v} == {"nn_bf16": n_iters},
                    f"slam chain {path}: launches {used}")
            models, scenes, m_ns, s_ns = batch_pairs([(clouds[i], clouds[i + 1])
                                                      for i in range(n_pairs)])
            stepped, sp, se = _lockstep(models, scenes, n_iters, kw, s_ns, m_ns)
            require(all(torch.equal(stepped[b, :len(c)], r.points)
                        for b, (r, c) in enumerate(zip(out, clouds[1:]))),
                    f"slam chain {path}: the stepped run is not the batched run")
            require(sp <= 1e-5 and se <= 1e-7,
                    f"slam chain {path}: an iteration {sp:.3g} / {se:.3g} from the pair's own")
            step = dict(lockstep_points_max_abs_err=f"{sp:.3e}",
                        lockstep_err_excess_over_rtol=f"{se:.3e}")
        if path == "auto":
            require(used["nn_grid"] >= n_pairs * n_iters and used["qcp_step"] >= n_pairs * n_iters
                    and used["nn_dense"] >= n_pairs, f"slam chain {path}: grid path ({used})")
        if path != "bcast_eigh":
            _add(launches, used)
        say("slam", case="register_chain_batched", path=path, pairs=n_pairs,
            rows=",".join(str(len(c)) for c in clouds), iters=n_iters,
            transform_max_abs_err_vs_pair=f"{worst:.3e}" if path != "auto" else "n/a",
            points_max_abs_err_vs_pair=f"{worst_p:.3e}" if path != "auto" else "n/a", **step,
            errs=",".join(f"{float(r.err):.3e}" for r in out), ms=f"{seconds * 1e3:.1f}",
            ms_per_pair=f"{seconds * 1e3 / n_pairs:.2f}",
            ms_per_pair_iter=f"{seconds * 1e3 / n_pairs / n_iters:.3f}", launches=used)
    return launches


def _slam_global_register() -> dict:
    """``global_register`` on two partly overlapping crops of bun000 (a
    third of each shared), the scene moved by 150 degrees about z and a
    shift, as tests/test_global_reg.py builds them: the pose within 6
    degrees and 0.03 of the truth, that test's bounds."""
    import numpy as np

    from icp_tpu_torch.engine.global_reg import global_register

    pts = _load("bun000.txt").astype(np.float32)
    x = pts[:, 0]
    lo, hi = x.min(), x.max()
    a = pts[x < lo + 0.6 * (hi - lo)]
    b = pts[x > lo + 0.4 * (hi - lo)]
    a, b = a[::max(1, a.shape[0] // 1500)], b[::max(1, b.shape[0] // 1500)]
    th = np.deg2rad(150.0)
    R = np.array([[np.cos(th), -np.sin(th), 0.0], [np.sin(th), np.cos(th), 0.0],
                  [0.0, 0.0, 1.0]], np.float32)
    t = np.array([0.3, -0.2, 0.1], np.float32)
    scene = (b @ R.T + t).astype(np.float32)
    res, used = _counted(lambda: global_register(a, scene, seed=0))
    seconds = _wall(lambda: global_register(a, scene, seed=0))
    R_got, t_got = res.transform.R.cpu().numpy(), res.transform.t.cpu().numpy()
    rot = float(np.rad2deg(np.arccos(np.clip((np.trace(R_got @ R) - 1.0) / 2.0, -1.0, 1.0))))
    dt = float(np.linalg.norm(t_got - (-R.T @ t)))
    require(rot < 6.0 and dt < 0.03, f"slam global_register: {rot:.3f} deg, {dt:.4f} off")
    require(used["knn_dense"] >= 3, f"slam global_register: K6 not taken ({used})")
    say("slam", case="global_register", model_rows=a.shape[0], scene_rows=b.shape[0],
        rot_err_deg=f"{rot:.4f}", t_err=f"{dt:.5f}", mutual=int(res.n_mutual),
        inlier_fraction=f"{float(res.inlier_fraction):.4f}", ms=f"{seconds * 1e3:.1f}",
        launches=used)
    return used


_SLAM_PAIR_RE = re.compile(r"\[slam\] pair (\d+)->(\d+): iters=(\d+) err=(\S+)")
_SLAM_CLOSURE_RE = re.compile(r"\[slam\] closure candidate (\d+)<-(\d+): inliers=(\S+)")
_SLAM_DRIFT_RE = re.compile(r"\[slam\] closure (\d+)<-(\d+) inconsistency: rot (\S+) -> (\S+), "
                            r"trans (\S+) -> (\S+)")


def _run_slam_cli(args: list[str], device: str = "cuda"):
    """(exit code, stderr, seconds, launches) of one ``icp-slam-torch`` run,
    the launch counts set to 0 just before it and read just after."""
    import torch

    from icp_tpu_torch.kernels import _build
    from icp_tpu_torch.slam.cli import main as slam_main

    _build.reset_counts()
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = slam_main([*args, "--device", device])
    if device == "cuda":
        torch.cuda.synchronize()
    return rc, err.getvalue(), time.perf_counter() - t0, dict(_build.LAUNCHES)


# The JAX icp-slam runs the CLI is held to (tests/fixtures/<folder>/): the
# relative tolerance of a pair's error when it converged and when it ran to
# the iteration cap (max-iter x levels).  A capped pair has not converged:
# on the grid fixture (--subsample 4) the trimmed error of pair 1->2
# oscillates from 1.36e-5 to 1.39e-5 between fine-level iterations (a CPU
# run of both packages), and float32 roundings of either package move where
# iteration 60 lands in that band (the port on the CPU: 1.5% from JAX's at
# 8 threads, 1.7% at 2), so it is held within 3e-2, the band's width with
# room.  Every step of that loop taken from JAX's state agrees with JAX's
# within 1.2e-7 (R).  Poses within 5e-3 (R) and 5e-4 (t) in both.
_SLAM_FIXTURES = {"torch_slam": dict(err_rtol=1e-2, capped_err_rtol=1e-2),
                  "torch_slam_grid": dict(err_rtol=1e-2, capped_err_rtol=3e-2)}


def _slam_cli_fixture(tmp: str, device: str = "cuda", folder: str = "torch_slam") -> dict:
    """``icp-slam-torch`` on the five scans with the JAX fixture's flags
    (``tests/fixtures/<folder>/README.md``): the same closure pairs, each
    pair's iterations, its error within ``_SLAM_FIXTURES``' relative
    tolerance, and the poses within 5e-3 (R) and 5e-4 (t): RANSAC draws
    differ, and the card's kernels (K1 and K6 on ``torch_slam``'s dense
    path; K4, K7 and K1's seeds on ``torch_slam_grid``'s grid path, which
    must launch K4) against JAX's on the CPU."""
    import numpy as np

    fix = os.path.join(FIXTURES, folder)
    with open(os.path.join(fix, "README.md")) as f:
        line = next(ln for ln in f if "icp_tpu.slam.cli" in ln)
    args = [os.path.join(ROOT, a) if a.startswith("data/") else a
            for a in line.split("icp_tpu.slam.cli", 1)[1].split()]
    levels = args[args.index("--multiscale") + 1:]
    levels = levels[:next((i for i, a in enumerate(levels) if a.startswith("--")), len(levels))]
    cap = int(args[args.index("--max-iter") + 1]) * len(levels)
    tol = _SLAM_FIXTURES[folder]
    poses = os.path.join(tmp, f"{folder}_poses.npz")
    rc, err, seconds, used = _run_slam_cli(
        args + ["--output-prefix", os.path.join(tmp, f"{folder}_"), "--poses", poses], device)
    require(rc == 0, f"slam cli {folder}: exit {rc}\n{err[-3000:]}")
    with open(os.path.join(fix, "stderr.txt")) as f:
        want = f.read()
    got_pairs, want_pairs = _SLAM_PAIR_RE.findall(err), _SLAM_PAIR_RE.findall(want)
    require([g[:3] for g in got_pairs] == [w[:3] for w in want_pairs],
            f"slam cli {folder}: pairs/iterations {got_pairs} against {want_pairs}")
    rels = [abs(float(g[3]) - float(w[3])) / float(w[3]) for g, w in zip(got_pairs, want_pairs)]
    for g, rel in zip(got_pairs, rels):
        held = tol["capped_err_rtol"] if int(g[2]) >= cap else tol["err_rtol"]
        require(rel <= held, f"slam cli {folder}: pair {g[0]}->{g[1]} error {rel:.3g} relative "
                             f"from JAX's, above {held}")
    got_c = [c[:2] for c in _SLAM_CLOSURE_RE.findall(err)]
    require(got_c == [c[:2] for c in _SLAM_CLOSURE_RE.findall(want)],
            f"slam cli {folder}: closures {got_c}")
    got, ref = np.load(poses), np.load(os.path.join(fix, "poses.npz"))
    dR, dt = float(np.abs(got["R"] - ref["R"]).max()), float(np.abs(got["t"] - ref["t"]).max())
    require(dR <= 5e-3 and dt <= 5e-4, f"slam cli {folder}: poses {dR:.3g} / {dt:.3g} off")
    grid = "grid" in args
    require(not grid or used["nn_grid"] > 0, f"slam cli {folder}: the grid path was not taken")
    say("slam", case="cli_fixture", fixture=folder,
        flags=" ".join(a for a in args if not a.startswith(ROOT)),
        pairs=";".join(f"{g[0]}->{g[1]}:{g[2]}:{g[3]}" for g in got_pairs),
        closures=",".join(f"{c[0]}<-{c[1]}" for c in got_c), err_max_rel_err=f"{max(rels):.3e}",
        err_rel_errs=",".join(f"{r:.3e}" for r in rels),
        poses_R_max_abs_err=f"{dR:.3e}", poses_t_max_abs_err=f"{dt:.3e}",
        seconds=f"{seconds:.2f}", launches_nn_grid=used["nn_grid"], launches=used)
    return used


def _slam_cli_full(tmp: str, device: str = "cuda", subsample: int = 1) -> dict:
    """``icp-slam-torch`` on the five scans at full resolution (31,702-40,257
    rows: the grid path, K7 normals) with ``--engine point_to_plane --init
    fpfh --trim 0.3 --multiscale 4 1 --detect-closures --closure-min-inliers
    0.06 --refine``: closure 0<-4 found, every pair's trimmed error under 5e-4, and the pose graph
    shrinking the closure's inconsistency (to 0.6 of it, rotation and
    translation), as tests/test_bunny_chain.py asks of its chain."""
    import numpy as np

    flags = ["--subsample", str(subsample), "--engine", "point_to_plane", "--init", "fpfh",
             "--trim", "0.3", "--multiscale", "4", "1", "--detect-closures",
             "--closure-min-inliers", str(FULL_CLOSURE_MIN), "--refine"]
    poses = os.path.join(tmp, "full_poses.npz")
    rc, err, seconds, used = _run_slam_cli(
        [os.path.join(ROOT, "data", f"{v}.txt") for v in BUNNY] + flags
        + ["--output-prefix", os.path.join(tmp, "full_"), "--poses", poses], device)
    require(rc == 0, f"slam cli full: exit {rc}\n{err[-3000:]}")
    pairs = _SLAM_PAIR_RE.findall(err)
    require(len(pairs) == 4 and all(float(p[3]) < 5e-4 for p in pairs),
            f"slam cli full: pair errors {pairs}")
    closures = _SLAM_CLOSURE_RE.findall(err)
    require(("0", "4") in [c[:2] for c in closures], f"slam cli full: closures {closures}")
    drift = {(d[0], d[1]): tuple(map(float, d[2:])) for d in _SLAM_DRIFT_RE.findall(err)}
    require(("0", "4") in drift, f"slam cli full: no pose graph over closure 0<-4\n{err[-2000:]}")
    r0, r1, t0, t1 = drift[("0", "4")]
    require(r1 < 0.6 * r0 and t1 < 0.6 * t0,
            f"slam cli full: closure inconsistency rot {r0} -> {r1}, trans {t0} -> {t1}")
    ba = re.search(r"\[slam\] bundle adjust: cost=(\S+)", err)
    got = np.load(poses)
    require(ba is not None and all(bool(np.isfinite(got[k]).all()) for k in "sRt"),
            f"slam cli full: bundle adjustment\n{err[-2000:]}")
    say("slam", case="cli_full_resolution", flags=" ".join(flags),
        pairs=";".join(f"{p[0]}->{p[1]}:{p[2]}:{p[3]}" for p in pairs),
        closures=",".join(f"{c[0]}<-{c[1]}:{c[2]}" for c in closures),
        rot_inconsistency=f"{r0:.4g}->{r1:.4g}", trans_inconsistency=f"{t0:.4g}->{t1:.4g}",
        bundle_adjust_cost=ba.group(1), wall_seconds=f"{seconds:.2f}",
        **{f"launches_{k}": used[k] for k in ("nn_dense", "icp_fused", "nn_grid", "knn_dense",
                                              "knn_grid")}, launches=used)
    return used


def phase_slam(seed: int, tmp: str) -> dict:
    """The slam phase: batching, global registration and the SLAM CLI on the
    card; returns the launches of the main-path runs."""
    launches = {}
    for used in (_slam_batched(seed), _slam_chain_batched(), _slam_global_register(),
                 _slam_cli_fixture(tmp), _slam_cli_fixture(tmp, folder="torch_slam_grid"),
                 _slam_cli_full(tmp)):
        _add(launches, used)
    return launches


# the sharded engines against the single-device ones on the card: the
# parity bound of __graft_entry__.py's _assert_parity (atol, rtol)
SHARDED_ATOL, SHARDED_RTOL = 1e-4, 2e-4
SHARDED_COUNTS = ("nn_dense", "nn_grid", "qcp_rotation", "knn_dense", "knn_grid")


def _group() -> dict:
    """The process group's size and backend, for the ``[sharded]`` lines."""
    import torch.distributed as dist

    return {"world": dist.get_world_size(), "backend": dist.get_backend()}


def _parity(label: str, got, want) -> float:
    """Max |got - want| of two results' points, held to the parity bound
    with the same iterations."""
    import torch

    g = got.result if hasattr(got, "result") else got
    w = want.result if hasattr(want, "result") else want
    require(int(g.iters) == int(w.iters),
            f"sharded {label}: {int(g.iters)} iterations, single-device {int(w.iters)}")
    a, b = g.points.double(), w.points.double()
    require(a.shape == b.shape and bool(torch.isfinite(a).all()), f"sharded {label}: bad points")
    ok = bool(((a - b).abs() <= SHARDED_ATOL + SHARDED_RTOL * b.abs()).all())
    require(ok, f"sharded {label}: points {max_abs(a, b):.3g} from the single-device run")
    return max_abs(a, b)


def _ms_per_iter(run, k1: int, k2: int) -> float:
    """Host-clock ms an iteration: the median of three runs of ``k2`` and of
    ``k1`` fixed iterations (``run(k)``, each ending in a synchronize),
    their difference over ``k2 - k1``."""
    run(k1)
    t1 = statistics.median(_wall(lambda: run(k1)) for _ in range(3))
    t2 = statistics.median(_wall(lambda: run(k2)) for _ in range(3))
    return (t2 - t1) / (k2 - k1) * 1e3


def _sharded_case(label: str, sharded, single, timed, k: tuple, smi: str, **info) -> dict:
    """One ``[sharded]`` line: ``sharded()`` (its launches counted) held
    against ``single()``, and ms/iter and device launches an iteration of
    both from ``timed(entry, n)``, which runs ``n`` fixed iterations of
    ``entry`` ("sharded" or "single")."""
    got, used = _counted(sharded)
    want = single()
    err = _parity(label, got, want)
    ms = _ms_per_iter(lambda n: timed("sharded", n), *k)
    single_ms = _ms_per_iter(lambda n: timed("single", n), *k)
    # runs of k[0] and k[1] iterations, as the ms/iter
    per_iter = {entry: launches_per_iter(lambda n, e=entry: timed(e, n + k[0] - 1), k[1] - k[0])
                for entry in ("sharded", "single")}
    res = got.result if hasattr(got, "result") else got
    say("sharded", case=label, **_group(), iters=int(res.iters),
        points_max_abs_err_vs_single=f"{err:.3e}", ms_per_iter=f"{ms:.4f}",
        single_ms_per_iter=f"{single_ms:.4f}", iter_counts=f"{k[0]},{k[1]}",
        device_launches_per_iter=f"{per_iter['sharded']:.1f}",
        single_device_launches_per_iter=f"{per_iter['single']:.1f}", **info,
        **{f"launches_{c}": used[c] for c in SHARDED_COUNTS}, card=repr(smi))
    return used


def _sharded_point_to_point(mesh, smi: str, seed: int) -> dict:
    """``icp_sharded`` (ring and all-gather, traced; trimmed; K1 each hop,
    K5 each iteration) and ``icp_sharded_2d`` on a (2, world / 2) mesh (1 x
    1 at world size 1) on cow; the
    sharded grid (K4 each hop) on horse, horse with a capacity of one
    candidate, and the 1M pair, 10 iterations (timed over iterations 7-10,
    past K4's first, larger tables)."""
    import torch
    import torch.distributed as dist

    from icp_tpu_torch import ICPConfig, icp, icp_sharded, icp_sharded_2d, make_mesh_2d

    total = {}
    world = dist.get_world_size()
    n_sp = 2 if world % 2 == 0 else 1
    mesh2 = make_mesh_2d(n_sp, world // n_sp)
    clouds = {name: tuple(torch.tensor(_load(f"{name}_{s}.txt"), dtype=torch.float32,
                                       device="cuda") for s in ("ref", "tr1"))
              for name in ("cow", "horse")}
    m1, s1, _ = scale_pair(seed)
    clouds["scale_1m"] = (m1, s1)
    cases = [  # label, clouds, config keywords, sharded entry keywords, iteration counts
        ("cow_ring", "cow", dict(nn_method="pallas"), dict(trace=True), (1, 21)),
        ("cow_allgather", "cow", dict(nn_method="pallas"), dict(ring=False, trace=True), (1, 21)),
        ("cow_trimmed", "cow", dict(nn_method="pallas", trim_fraction=0.1), {}, (1, 21)),
        ("cow_2d", "cow", dict(nn_method="pallas"), dict(mesh2d=True), (1, 21)),
        ("horse_grid", "horse", {}, dict(trace=True), (1, 11)),
        ("horse_grid_cap1", "horse", dict(grid_max_candidates=1), {}, (1, 6)),
        ("scale_1m_grid", "scale_1m", dict(max_iter=10, threshold=-math.inf), {}, (6, 10)),
    ]
    for label, name, cfg_kw, kw, k in cases:
        model, scene = clouds[name]
        kw = dict(kw)
        two_d = kw.pop("mesh2d", False)

        def sharded(cfg, kw=kw, two_d=two_d, model=model, scene=scene):
            if two_d:
                return icp_sharded_2d(model, scene, cfg, mesh=mesh2, **kw)
            return icp_sharded(model, scene, cfg, mesh=mesh, **kw)

        def timed(entry, n, cfg_kw=cfg_kw, sharded=sharded, model=model, scene=scene):
            cfg = ICPConfig(**{**cfg_kw, "max_iter": n, "threshold": -math.inf})
            res = sharded(cfg) if entry == "sharded" else icp(model, scene, cfg)
            res = res.result if hasattr(res, "result") else res
            require(int(res.iters) == n, f"sharded {label}: timed run stopped early")

        cfg = ICPConfig(**{"max_iter": 30, **cfg_kw})
        used = _sharded_case(label, lambda: sharded(cfg), lambda: icp(model, scene, cfg,
                                                                        trace=kw.get("trace", False)),
                             timed, k, smi, rows=scene.shape[0])
        hop = "nn_grid" if name != "cow" else "nn_dense"
        require(used[hop] >= 1 and used["qcp_rotation"] >= 1,
                f"sharded {label}: {hop} or K5 not launched ({used})")
        _add(total, used)
    return total


def _sharded_plane(mesh, smi: str) -> dict:
    """The sharded plane engines through their entry points
    (``icp_point_to_plane_sharded``, ``icp_symmetric_sharded``,
    ``icp_generalized_sharded``), 30 iterations, as a user calls them
    (normals estimated inside): point-to-plane on cow (K6 normals, K1 each
    hop) and the three on horse (K7 normals, ``gn_sharded_grid`` with K4's
    normals payload), each against the single-device engine."""
    import torch

    from icp_tpu_torch import (ICPConfig, icp_generalized_sharded, icp_point_to_plane_sharded,
                               icp_symmetric_sharded)
    from icp_tpu_torch.engine.plane import run_engine
    from icp_tpu_torch.ops.normals import estimate_normals

    def sharded(engine, model, scene, cfg, model_normals=None, scene_normals=None, **kw):
        """The engine's sharded entry point, the normals under its own
        keywords."""
        if engine == "point_to_plane":
            return icp_point_to_plane_sharded(model, scene, cfg, normals=model_normals,
                                              mesh=mesh, **kw)
        if engine == "symmetric":
            return icp_symmetric_sharded(model, scene, cfg, normals=model_normals,
                                         scene_normals=scene_normals, mesh=mesh, **kw)
        return icp_generalized_sharded(model, scene, cfg, model_normals=model_normals,
                                       scene_normals=scene_normals, mesh=mesh, **kw)

    total = {}
    for name, engines in (("cow", ("point_to_plane",)),
                          ("horse", ("point_to_plane", "symmetric", "gicp"))):
        model, scene = (torch.tensor(_load(f"{name}_{s}.txt"), dtype=torch.float32,
                                     device="cuda") for s in ("ref", "tr1"))
        normals = {"model_normals": estimate_normals(model),
                   "scene_normals": estimate_normals(scene)}
        for engine in engines:
            cfg = ICPConfig(max_iter=30)

            def timed(entry, n, engine=engine, model=model, scene=scene):
                c = ICPConfig(max_iter=n, threshold=-math.inf)
                fn = sharded if entry == "sharded" else run_engine
                res = fn(engine, model, scene, c, **normals)
                require(int(res.iters) == n, f"sharded {engine}: timed run stopped early")

            used = _sharded_case(
                f"{engine}_{name}",
                lambda: sharded(engine, model, scene, cfg, trace=True),
                lambda: run_engine(engine, model, scene, cfg, trace=True), timed, (1, 11),
                smi, rows=scene.shape[0])
            knn = "knn_dense" if name == "cow" else "knn_grid"
            hop = "nn_dense" if name == "cow" else "nn_grid"
            require(used[knn] >= 1 and used[hop] >= 1,
                    f"sharded {engine}_{name}: {knn} or {hop} not launched ({used})")
            _add(total, used)
    return total


def _sharded_bundle_adjust(mesh, smi: str) -> dict:
    """``bundle_adjust_sharded`` against ``bundle_adjust`` on the bunny
    chain's correspondences, made as ``icp-slam-torch --refine`` makes
    them, from the chain at the SLAM fixture's flags (every 16th point,
    point-to-plane, PCA init, trim 0.3, scales 4 and 1): poses within
    1e-5."""
    import numpy as np
    import torch

    from icp_tpu_torch import ICPConfig
    from icp_tpu_torch.ops.distance import closest_point_indices
    from icp_tpu_torch.ops.padding import resolve_auto_bucket
    from icp_tpu_torch.ops.transform import apply_similarity
    from icp_tpu_torch.slam.pairwise import chain_to_world_poses, register_chain
    from icp_tpu_torch.slam.pose_graph import bundle_adjust, bundle_adjust_sharded

    clouds = [_load(f"{v}.txt")[::16].astype(np.float32) for v in BUNNY]
    cfg = ICPConfig(max_iter=30, validate_inputs=False, with_scale=False, trim_fraction=0.3)
    pairs = register_chain(clouds, cfg, multiscale=(4, 1), init="pca", engine="point_to_plane",
                           bucket_quantum=resolve_auto_bucket(clouds), device="cuda")
    poses = chain_to_world_poses(pairs)
    corr = []
    for k, pr in enumerate(pairs):
        src = torch.as_tensor(clouds[k + 1], device="cuda")
        tgt = torch.as_tensor(clouds[k], device="cuda")
        idx = closest_point_indices(apply_similarity(src, pr.transform), tgt, method="pallas")
        corr.append((k, k + 1, tgt[idx.long()], src))
    single, cost = bundle_adjust(poses, corr, n_iters=8)
    (got, got_cost), used = _counted(lambda: bundle_adjust_sharded(poses, corr, mesh=mesh,
                                                                    n_iters=8))
    err = max(max(max_abs(a.R, b.R), max_abs(a.t, b.t)) for a, b in zip(got, single))
    require(err <= 1e-5 and math.isfinite(got_cost),
            f"sharded bundle_adjust: poses {err:.3g} from bundle_adjust")
    ms = statistics.median(_wall(lambda: bundle_adjust_sharded(poses, corr, mesh=mesh))
                           for _ in range(3)) * 1e3
    single_ms = statistics.median(_wall(lambda: bundle_adjust(poses, corr))
                                  for _ in range(3)) * 1e3
    say("sharded", case="bundle_adjust_bunny", **_group(),
        rows=sum(len(c[2]) for c in corr), poses_max_abs_err_vs_single=f"{err:.3e}",
        cost=f"{got_cost:.6g}", single_cost=f"{cost:.6g}", ms=f"{ms:.3f}",
        single_ms=f"{single_ms:.3f}", card=repr(smi))
    return used


def _sharded_cli(tmp: str, smi: str) -> dict:
    """``icp-torch --device cuda --sharded`` on cow_tr1 10 against the
    reference binary's fixture, as the cli phase holds the unsharded run
    (rank 0 prints and writes; the other ranks check their exit code)."""
    import torch.distributed as dist

    out_path = os.path.join(tmp, "sharded_cow_tr1_output.txt")
    rc, got, err, seconds, used = _run_cli(
        [os.path.join(ROOT, "data", "cow_ref.txt"), os.path.join(ROOT, "data", "cow_tr1.txt"),
         "10", "--output", out_path, "--sharded"])
    require(rc == 0, f"sharded cli: exit {rc}\n{err}")
    if dist.get_rank() != 0:
        require(not got, "sharded cli: a rank other than 0 printed the trace")
        return used
    worst = _check_trace("sharded_cow_tr1", got,
                         _golden(os.path.join(FIXDIR, "cow_tr1_stderr.txt")), 7)
    off = _check_output("sharded_cow_tr1", out_path,
                        os.path.join(FIXDIR, "cow_tr1_output.txt"), 1e-5)
    require(used["nn_dense"] >= 7 and used["qcp_rotation"] >= 7,
            f"sharded cli: K1 + K5 path not taken ({used})")
    say("sharded", case="cli_cow_tr1", **_group(), iters=len(got),
        trace_max_rel_err=f"{worst:.3e}", output_max_abs_err=f"{off:.3e}",
        seconds=f"{seconds:.3f}", **{f"launches_{c}": used[c] for c in SHARDED_COUNTS},
        card=repr(smi))
    return used


def phase_sharded(seed: int, tmp: str, smi: str) -> dict:
    """The sharded engines on an NCCL group (world size 1 unless
    ``chip_smoke.py`` runs under ``torchrun``): each against its
    single-device engine on the rank's card; returns the launches of the
    sharded runs."""
    import torch.distributed as dist

    from icp_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    require(dist.get_backend() == "nccl", f"sharded: an NCCL group expected, got "
                                          f"{dist.get_backend()}")
    launches = {}
    try:
        for used in (_sharded_point_to_point(mesh, smi, seed), _sharded_plane(mesh, smi),
                     _sharded_bundle_adjust(mesh, smi), _sharded_cli(tmp, smi)):
            _add(launches, used)
    finally:
        dist.destroy_process_group()
    missing = [k for k in ("nn_dense", "nn_grid", "qcp_rotation", "knn_dense", "knn_grid")
               if not launches.get(k)]
    require(not missing, f"sharded: kernels never launched on the sharded paths: {missing}")
    return launches


# The harness's rows (``icp_tpu_torch/bench/harness.py``), each driven alone
# with the counts set to 0 just before it; horse leaves out the host NumPy
# engine (2.35 G brute-force pairs an iteration on the host).
BENCH_ROWS = ("closest_bcast", "closest_matmul", "find_alignment", "compute_centroid",
              "err_compute", "err_compute_alignment", "closest_pallas", "closest_grid",
              "closest_bf16", "full_loop", "full_loop_pipeline", "full_loop_grid",
              "full_loop_numpy", "global_register", "batched_bucketed", "full_loop_sharded")
BENCH_ITERS = 20  # benchmark_matrix's n_iters
# Iterations a loop row runs: one warm-up and 5 timed runs at n and at
# n + 500 (the batched row: n + 180).
BENCH_LOOP_ITERS = 6 * (2 * BENCH_ITERS + 500)
BENCH_BATCH_ITERS = 6 * (2 * BENCH_ITERS + 180)
# The cow loop rows: ``bench_torch.py`` times these three paths (its
# ``per_iter_us_*``); here a short run of each holds its launches.
BENCH_COW_LOOPS = {"full_loop": "fused", "full_loop_pipeline": "pipeline",
                   "full_loop_grid": "grid"}
BENCH_SHORT = (2, 4, 1)  # loop_per_iter's small, big, reps: 12 iterations
# rows of torch ops or host NumPy alone: no kernel of the port
BENCH_TORCH_ROWS = ("closest_bcast", "closest_matmul", "compute_centroid", "err_compute",
                    "err_compute_alignment", "full_loop_numpy")
# the kernel each other op row must launch
BENCH_KERNEL_OF = {"find_alignment": "qcp_rotation", "closest_pallas": "nn_dense",
                   "closest_grid": "nn_grid", "closest_bf16": "nn_bf16",
                   "global_register": "knn_dense", "full_loop_sharded": "nn_dense"}
# The wrappers whose launches in the bench phase are held against their
# plain versions at the shapes and on the inputs the rows gave them: K1
# (K10) alone and with the pair axis (horse 48,485^2, the grid seeds, the
# bucketed batches, the sharded ring, the scaling cell), K2 alone and with
# the pair axis, K5, K4 on the rows' tables and K6 at global_register's k.
# K3 and K9 run here on the kernels phase's inputs (cow's loop; cow and
# horse, tr1 onto ref), where they are held.
BENCH_HELD = (("icp_tpu_torch.kernels.nn_dense", "_launch"),
              ("icp_tpu_torch.kernels.qcp", "qcp_step"),
              ("icp_tpu_torch.kernels.qcp", "qcp_rotation_from"),
              ("icp_tpu_torch.kernels.nn_grid", "nn_grid"),
              ("icp_tpu_torch.kernels.knn_dense", "knn_dense"))
BENCH_HELD_PAIRS = 1 << 28  # above it a plain NN or kNN is held on a sample of rows
BENCH_HELD_ROWS = 16384


def _signature(args, kwargs) -> tuple:
    import torch

    def one(v):
        if isinstance(v, torch.Tensor):
            return ("tensor", tuple(v.shape), str(v.dtype))
        return v if v is None or isinstance(v, (bool, int, float, str)) else type(v).__name__
    return tuple(map(one, args)) + tuple((k, one(v)) for k, v in sorted(kwargs.items()))


def _clone(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


@contextlib.contextmanager
def _recording_launches(records: dict):
    """Within the body each wrapper of ``BENCH_HELD`` is replaced, wherever a
    loaded module of the port holds it, by one that keeps its first call at
    each signature (argument shapes, dtypes and values) in ``records``: the
    bound arguments as they came in, the result, and the tensors as they
    were left (K2 works in place).  The launches and their counts are the
    wrapper's own; every name is put back on exit."""
    import importlib
    import inspect

    patched = []
    try:
        for modname, fname in BENCH_HELD:
            orig = getattr(importlib.import_module(modname), fname)
            sig = inspect.signature(orig)

            def wrapper(*args, _orig=orig, _name=fname, _sig=sig, **kwargs):
                key = (_name, _signature(args, kwargs))
                if key in records:
                    return _orig(*args, **kwargs)
                before = _sig.bind(*_clone(list(args)), **_clone(kwargs))
                before.apply_defaults()
                out = _orig(*args, **kwargs)
                left = _sig.bind(*_clone(list(args)), **_clone(kwargs)).arguments
                records[key] = (before.arguments, _clone(out), left)
                return out

            for mod in list(sys.modules.values()):
                if not getattr(mod, "__name__", "").startswith("icp_tpu_torch"):
                    continue
                for attr, val in list(vars(mod).items()):
                    if val is orig:
                        patched.append((mod, attr, orig))
                        setattr(mod, attr, wrapper)
        yield
    finally:
        for mod, attr, orig in reversed(patched):
            setattr(mod, attr, orig)


def _sample_rows(rng, n: int, m: int):
    """All rows, or ``BENCH_HELD_ROWS`` seeded ones where n x m exceeds
    ``BENCH_HELD_PAIRS``."""
    import numpy as np
    import torch

    if n * m <= BENCH_HELD_PAIRS or n <= BENCH_HELD_ROWS:
        return slice(None), n
    rows = torch.as_tensor(np.sort(rng.choice(n, BENCH_HELD_ROWS, replace=False)))
    return rows, BENCH_HELD_ROWS


def _nan_equal_within(a, b, tol: float) -> float:
    """The largest difference of a and b where neither is NaN, NaN where
    the other is; raises past ``tol``."""
    import torch

    require(torch.equal(torch.isnan(a), torch.isnan(b)), "NaN where plain has none")
    err = max_abs(torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))
    require(err <= tol, f"{err:.3e} from plain, above {tol:.1e}")
    return err


def _hold_nn_dense(a: dict, out, rng) -> dict:
    """K1 (K10) on one pair or B: each pair's indices and distances bit-equal
    to ``nn_dense_plain`` on its (sampled) rows; with the pair axis, each
    pair also bit-equal to its own single launch."""
    import torch

    from icp_tpu_torch.kernels import nn_dense

    scene, model, pairs, impl = a["scene"], a["model"], a["pairs"], a["distance_impl"]
    idx, d2 = out if a["with_dist"] else (out, None)
    batched = scene.ndim == 3
    checked = 0
    for b in range(pairs):
        s, m = (scene[b], model[b]) if batched else (scene, model)
        ib = idx[b] if batched else idx
        db = None if d2 is None else (d2[b] if batched else d2)
        rows, k = _sample_rows(rng, s.shape[0], m.shape[0])
        ip, dp = nn_dense.nn_dense_plain(s[rows].contiguous(), m, with_dist=True,
                                         distance_impl=impl)
        require(torch.equal(ib[rows], ip), f"indices of pair {b} differ from plain")
        require(db is None or same_nan(db[rows], dp), f"d2 of pair {b} differs from plain")
        if batched:
            one = nn_dense.nn_dense(s.contiguous(), m.contiguous(), with_dist=True,
                                    distance_impl=impl)
            require(torch.equal(one[0], ib) and (db is None or same_nan(one[1], db)),
                    f"pair {b} differs from its single launch")
        checked += k
    return {"form": impl, "pairs": pairs, "rows_held": checked, "bit_equal_plain": True,
            "equal_single_launches": batched or None}


def _hold_qcp_step(a: dict, left: dict) -> dict:
    """K2 on one pair or B: the state, control and error buffer it left
    against ``qcp_step_plain`` from the same inputs (control equal, the rest
    within 1e-9 as in the kernels phase); with the pair axis, each pair
    bit-equal to its own single launch."""
    import torch

    from icp_tpu_torch.kernels import qcp

    kw = {k: a[k] for k in ("with_scale", "threshold", "err_factor", "converge", "guard")}
    parts = a["partials"]
    st, ctl, errs = a["state"].clone(), a["ctl"].clone(), a["errs"].clone()
    qcp.qcp_step_plain(parts, st, ctl, errs, **kw)
    k_st, k_ctl, k_errs = left["state"], left["ctl"], left["errs"]
    require(torch.equal(k_ctl, ctl), "loop control differs from plain")
    err = max(_nan_equal_within(k_st, st, 1e-9), _nan_equal_within(k_errs, errs, 1e-9))
    batched = parts.ndim == 3
    if batched:
        for b in range(parts.shape[0]):
            one = (a["state"][b:b + 1].clone(), a["ctl"][b].clone(), a["errs"][b].clone())
            qcp.qcp_step(parts[b].contiguous(), *one, **kw)
            require(torch.equal(one[0], k_st[b:b + 1]) and torch.equal(one[1], k_ctl[b])
                    and same_nan(one[2], k_errs[b]), f"pair {b} differs from its single launch")
    return {"pairs": parts.shape[0] if batched else 1, "rows": parts.shape[-2],
            "max_abs_err": err, "bit_equal_plain": err == 0.0,
            "equal_single_launches": batched or None}


def _hold_recorded(records: dict, seed: int) -> list:
    """Each recorded launch against its plain version (``BENCH_HELD``), one
    ``[bench] held`` line each; returns the lines' records."""
    import numpy as np
    import torch

    from icp_tpu_torch.kernels import knn_dense, nn_grid, qcp

    rng = np.random.default_rng(seed + 14)
    held = []
    for (name, sig), (a, out, left) in records.items():
        shapes = [tuple(v.shape) for v in a.values() if isinstance(v, torch.Tensor)]
        label = f"{name} {shapes}"
        try:
            if name == "_launch":
                info = _hold_nn_dense(a, out, rng)
                name = "nn_dense" if a["distance_impl"] == "vpu" else "nn_dense_mxu"
            elif name == "qcp_step":
                info = _hold_qcp_step(a, left)
            elif name == "qcp_rotation_from":
                want = qcp.qcp_rotation_from_plain(a["S"], a["gp"], a["gy"])
                require(all(torch.equal(g, w) for g, w in zip(out, want)), "differs from plain")
                name, info = "qcp_rotation", {"dtype": str(a["S"].dtype), "bit_equal_plain": True}
            elif name == "nn_grid":
                want = nn_grid.nn_grid_plain(a["cand"], a["counts"], a["scene"], a["tiles"],
                                             a["scene_tile"], a["payload"], kd_row=a["kd_row"])
                require(all((g is None and w is None) or same_nan(g, w) for g, w in zip(out, want)),
                        "d2, idx, y or payload differ from plain")
                info = {**k4_table(a["cand"], a["counts"], a["tiles"].shape[0],
                                   a["tiles"].shape[1], a["scene_tile"]), "bit_equal_plain": True}
            else:  # knn_dense
                q, pts, k = a["query"], a["points"], a["k"]
                rows, n_rows = _sample_rows(rng, q.shape[0], pts.shape[0])
                dp, ip = knn_dense.knn_dense_plain(q[rows].contiguous(), pts, k)
                require(torch.equal(out[1][rows], ip) and same_nan(out[0][rows], dp),
                        "differs from plain")
                info = {"k": k, "rows_held": n_rows, "bit_equal_plain": True}
        except SmokeError as e:
            raise SmokeError(f"bench held {label}: {e}") from None
        rec = {"kernel": name, "shapes": shapes, **info}
        held.append(rec)
        print("[bench] held " + json.dumps(rec))
    return held


def _bench_launches(label: str, key: str, used: dict, fused: bool, it: int) -> None:
    """The kernels a harness row must have launched: the loop rows once an
    iteration (``it`` of them; the pipeline row no K3: the proof that the
    fused gate was off), the op rows their kernel, the torch rows none."""
    def exact(**want):
        got = {k: used.get(k, 0) for k in want}
        require(got == want, f"bench {label}: launches {got}, want {want}")

    if key in BENCH_TORCH_ROWS:
        require(not any(used.values()), f"bench {label}: a torch row launched {used}")
    elif key in BENCH_KERNEL_OF:
        require(used.get(BENCH_KERNEL_OF[key], 0) > 0, f"bench {label}: no "
                f"{BENCH_KERNEL_OF[key]} launch ({used})")
    elif key == "full_loop" and fused:
        exact(icp_fused=it, nn_dense=0, qcp_step=0)
    elif key in ("full_loop", "full_loop_pipeline"):
        exact(icp_fused=0, nn_dense=it, qcp_step=it)
    elif key == "full_loop_grid":
        exact(icp_fused=0, nn_grid=it, qcp_step=it)
    elif key == "batched_bucketed":
        exact(icp_fused=0, nn_dense=it, qcp_step=it)
    else:
        raise SmokeError(f"bench {label}: no launch rule for row {key!r}")


def _bench_cow_loop(key: str, fused: bool) -> dict:
    """A cow loop row's path, run short (``BENCH_SHORT``) for its launches;
    its time is ``bench_torch.py``'s."""
    import torch

    from icp_tpu_torch.bench.harness import load_pair, loop_per_iter

    with contextlib.redirect_stderr(io.StringIO()):
        ref, tr1 = (torch.as_tensor(a, dtype=torch.float32, device="cuda")
                    for a in load_pair("cow"))
    small, big, reps = BENCH_SHORT
    _, used = _counted(lambda: loop_per_iter(ref, tr1, BENCH_COW_LOOPS[key], small, big, reps))
    _bench_launches(f"cow {key}", key, used, fused, (1 + reps) * (small + big))
    print("[bench] " + json.dumps({"workload": "cow", "row": key, "path": BENCH_COW_LOOPS[key],
                                   "iterations": (1 + reps) * (small + big),
                                   "time": "bench_torch.py per_iter_us_" + BENCH_COW_LOOPS[key],
                                   "launches": {k: v for k, v in used.items() if v}}))
    return used


def _bench_matrix(workload: str) -> dict:
    """Every row of ``benchmark_matrix`` at ``workload`` on the card, one row
    a call (the cow loop rows by ``_bench_cow_loop``): a time or
    ``unresolved``, shares at most 100%, and the launches of
    ``_bench_launches``.  Returns the rows' launches."""
    import torch

    from icp_tpu_torch.bench.harness import benchmark_matrix, load_pair
    from icp_tpu_torch.kernels.icp_fused import MAX_FUSED_MODEL

    with contextlib.redirect_stderr(io.StringIO()):
        fused = load_pair(workload)[0].shape[0] <= MAX_FUSED_MODEL
    total = {}
    for key in BENCH_ROWS:
        if workload == "horse" and key == "full_loop_numpy":
            continue
        if workload == "cow" and key in BENCH_COW_LOOPS:
            _add(total, _bench_cow_loop(key, fused))
            continue
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()) as log:
            rows, used = _counted(lambda: benchmark_matrix(
                n_iters=BENCH_ITERS, include=[key], workload=workload))
        seconds = time.perf_counter() - t0
        if not rows:  # the torch NN rows above 4e8 pairs, as in JAX
            require(key in ("closest_bcast", "closest_matmul") and "skipped" in log.getvalue(),
                    f"bench {workload}: row {key} gave nothing")
            print("[bench] " + json.dumps({"workload": workload, "row": key, "skipped": True}))
            continue
        require(len(rows) == 1, f"bench {workload} {key}: {len(rows)} rows")
        row = rows[0]
        label = f"{workload} {row['benchmark']}"
        require(row.get("unresolved") is True or row.get("time_us", 0) > 0,
                f"bench {label}: neither a positive time nor unresolved: {row}")
        for share in ("mfu_pct", "mfu_iter_pct", "hbm_util_pct"):
            if share in row:
                require(0 <= row[share] <= 100, f"bench {label}: {share} {row[share]} above 100%")
        it = BENCH_BATCH_ITERS if key == "batched_bucketed" else BENCH_LOOP_ITERS
        _bench_launches(label, key, used, fused, it)
        _add(total, used)
        print("[bench] " + json.dumps({"workload": workload, **row, "seconds": round(seconds, 2),
                                       "launches": {k: v for k, v in used.items() if v}}))
    torch.cuda.synchronize()
    return total


def _bench_headline() -> None:
    """``python3 bench_torch.py`` as a child: rc 0, the gate at 7
    iterations, and its last line the headline record."""
    env = dict(os.environ, ICP_BENCH_TOTAL_TIMEOUT="600")  # the supervisor kills its child
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py")], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=700)
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    require(proc.returncode == 0 and lines, f"bench_torch.py exited {proc.returncode}: "
            f"{proc.stdout[-1000:]}\n{proc.stderr[-3000:]}")
    gate = re.search(r"\[bench\] convergence gate: err=(\S+) iters=(\d+) "
                     r"alignment_rmse_vs_ref=(\S+)", proc.stderr)
    require(gate is not None and int(gate.group(2)) == 7,
            f"bench_torch.py: no convergence gate at 7 iterations in {proc.stderr[-2000:]}")
    rec = json.loads(lines[-1])
    require(rec.get("metric") == "icp_iter_per_s_cow" and rec.get("value", 0) > 0
            and rec.get("path") in ("fused", "pipeline", "grid")
            and (rec.get("iters_small"), rec.get("iters_big")) == (20, 520),
            f"bench_torch.py: a headline record at 20 and 520 iterations expected, "
            f"got {lines[-1]}")
    print(f"[bench] gate err={gate.group(1)} iters={gate.group(2)} rmse={gate.group(3)} "
          f"bench_torch_seconds={time.perf_counter() - t0:.1f}")
    print("[bench] headline " + json.dumps(rec))


def phase_bench(seed: int) -> dict:
    """The port's harness on the card (``[bench]`` lines): every row at cow,
    every row but the NumPy engine at horse; one scaling cell at world 1
    (NCCL); every launch of ``BENCH_HELD`` at a new shape held against its
    plain version; ``bench_torch.py``.  Returns the rows' launches."""
    import torch.distributed as dist

    from icp_tpu_torch.bench.scaling import run_cell

    t0 = time.perf_counter()
    launches, records = {}, {}
    try:
        with _recording_launches(records):
            for workload in ("cow", "horse"):
                _add(launches, _bench_matrix(workload))
            cell = run_cell(1, 65536, 5, True)
        require(cell["wall_s"] > 0 and math.isfinite(cell["err"]),
                f"bench: scaling cell {cell}")
        print("[bench] scaling " + json.dumps(cell))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    t1 = time.perf_counter()
    held = _hold_recorded(records, seed)
    kinds = {r["kernel"] for r in held}
    require({"nn_dense", "qcp_step", "qcp_rotation", "nn_grid", "knn_dense"} <= kinds,
            f"bench: the held launches miss a kernel: {sorted(kinds)}")
    say("bench", held_launches=len(held), held_seconds=f"{time.perf_counter() - t1:.1f}")
    _bench_headline()
    say("bench", seconds=f"{time.perf_counter() - t0:.1f}")
    return launches


@contextlib.contextmanager
def _torchrun_rank():
    """Under ``torchrun`` (``--nproc-per-node 4 chip_smoke.py --phases
    sharded``): this process joins the environment's NCCL group on its
    ``LOCAL_RANK`` card, and every rank but 0 runs with its standard output
    silenced.  Otherwise nothing."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        yield
        return
    import torch.distributed as dist

    from icp_tpu_torch.parallel.mesh import ensure_process_group

    ensure_process_group()
    if dist.get_rank() == 0:
        yield
        return
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        yield


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="kernels,cli,features,slam,sharded,scale,bench",
                    help="comma list of kernels, cli, features, slam, sharded, scale, bench "
                         "(device and build always run)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    with _torchrun_rank():
        return run_phases(args.seed, phases)


def run_phases(seed: int, phases: set) -> int:
    import torch

    smi = phase_device()
    phase_build()
    record = {}
    if "kernels" in phases:
        phase_kernels(seed, record)
    launches = {}
    if "cli" in phases:
        out_dir = os.path.join(ROOT, "chiprun_out", "chip_smoke")
        os.makedirs(out_dir, exist_ok=True)
        launches = phase_cli(out_dir)
        missing = [k for k in KERNELS if not launches.get(k)]
        require(not missing, f"kernels never launched on the main paths: {missing}")
        phase_loop_times()
    if "features" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            _add(launches, phase_features(tmp))
    if "slam" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            _add(launches, phase_slam(seed, tmp))
    if "sharded" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            _add(launches, phase_sharded(seed, tmp, smi))
    if "scale" in phases:
        phase_scale(seed)
    if "bench" in phases:
        _add(launches, phase_bench(seed))
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        rec = record.get(name, entry(None, None, None, (None, None)))
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches.get(name), **rec})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
