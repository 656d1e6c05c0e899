#!/usr/bin/env python3
"""Where the time goes in the port's loops, on one CUDA card.

    python3 scripts/profile_torch.py [--out DIR] [--root DIR] [--cells LIST]

For each cell — cow_tr1 on the fused path (one K3 launch an iteration),
horse_tr1 on the grid path (K4 + torch + K2), and the 1,000,000-point pair
of ``chip_smoke.py`` on the grid path, each with the point-to-point engine
and the three plane engines (point-to-plane, symmetric, GICP: dense K1 on
cow, grid K4 with the normals payload elsewhere) — it times
fixed-iteration loops without the profiler (ms/iter from the difference of
two iteration counts), then runs one loop under ``torch.profiler`` and
prints the device time by kernel and an iteration's device microseconds
(the window's kernel time over its iterations, set-up included), the
device's busy share of the profiled window (union of kernel intervals over
the window's wall time) and each launch's time of the hand-written kernels.
The plane cells take their normals from ``estimate_normals`` calls (K6 on
cow, K7 elsewhere; the model's is profiled the same way, and symmetric and
GICP also take the scene's).  The ``bf16`` cell is the symmetric engine
with ``nn_method="bf16"`` (K9 each iteration) on cow_tr1, and the ``k5``
cell the point-to-point loop with ``nn_method="bcast"`` and
``solver="qcp_fused"`` (K5 each iteration, the rest torch) on cow_tr1.
The ``trim`` cells are the point-to-point loop with ``trim_fraction=0.1``:
cow_tr1 on the pipeline (K1 + the quantile + K2), horse_tr1 and the 1M
pair on the grid path (K4, the quantile of its distances, K2); their
``host_waits`` count the loop's flag reads (one a chunk of 8 iterations)
and any other wait.  The ``sharded`` cells are ``icp_sharded`` on a
world-1 NCCL group (cow_tr1 with K1 each hop and K5 each iteration,
horse_tr1 on the sharded grid), each beside the same host-side breakdown
of the host operations by their own CPU time.
``--cells`` picks cells (``cow``, ``horse``, ``1M``, ``bf16``, ``k5``,
``trim``, ``sharded``; default all);
``--root`` names the checkout whose ``icp_tpu_torch`` is profiled (default
this one; it needs ``engine/plane.py``), so two commits can be profiled in
one call with this script.
Chrome traces go to ``--out`` (default ``chiprun_out/profile``).
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import importlib.util

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# K1 runs as a fold and an epilogue, K4 as a plan, a fold and an epilogue,
# K7 as a plan, a fold and a merge, K9 as a prep and a fold that merges its
# chunks in the last block (one kernel before the tensor-core redesign);
# K5 and K8 as one kernel each (K5 an instance a input type)
OURS = ("nn_dense_fold_kernel", "nn_dense_epilogue_kernel", "qcp_step_kernel",
        "icp_fused_kernel", "nn_grid_plan_kernel", "nn_grid_fold_kernel",
        "nn_grid_epilogue_kernel", "qcp_rotation_kernel", "knn_dense_kernel",
        "knn_grid_plan_kernel", "knn_grid_fold_kernel", "knn_grid_merge_kernel",
        "nn_chunked_kernel", "nn_bf16_kernel", "nn_bf16_prep_kernel", "nn_bf16_fold_kernel")
CELLS = ("cow", "horse", "1M", "bf16", "k5", "trim", "sharded")


def _us(event) -> float:
    return event.time_range.end - event.time_range.start


def _busy_share(events, wall_us: float) -> float:
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy / wall_us


def _timed(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_cell(name, label, run, n_iters, out_dir, host_top: int = 0):
    """``run(k)``: k iterations of the cell's loop (set-up included);
    ``n_iters`` 0 profiles one call of ``run`` as it is.  ``host_top``:
    also print that many host operations with the most CPU time of their
    own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run(max(n_iters, 1))
    if n_iters:
        t1 = statistics.median(_timed(lambda: run(1)) for _ in range(3))
        tk = statistics.median(_timed(lambda: run(n_iters + 1)) for _ in range(3))
        print(f"[{name}] {label} ms_per_iter={(tk - t1) / n_iters * 1e3:.4f} "
              f"setup_plus_one_iter_ms={t1 * 1e3:.3f}", flush=True)
    else:
        t = statistics.median(_timed(lambda: run(0)) for _ in range(3))
        print(f"[{name}] {label} ms={t * 1e3:.3f}", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _timed(lambda: run(n_iters))
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    total = sum(_us(e) for e in kernels) or float("nan")
    # host waits on the card inside the window (the loop's once-a-chunk
    # flag read is one; more per iteration mean a hidden synchronisation)
    waits = sum(1 for e in prof.events() if e.device_type != DeviceType.CUDA
                and e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                               "cudaMemcpy", "cudaEventSynchronize"))
    per_iter = f"{total / n_iters:.2f}" if n_iters else "n/a"
    print(f"[{name}] profiled iters={n_iters} wall_ms={wall * 1e3:.3f} "
          f"device_kernel_ms={total / 1e3:.3f} device_us_per_iter={per_iter} "
          f"device_busy_share={_busy_share(kernels, wall * 1e6):.3f} "
          f"kernel_launches={len(kernels)} host_waits={waits}", flush=True)
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + _us(e), c + 1)
    for kname, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"[{name}]   {t / 1e3:9.3f} ms {100 * t / total:5.1f}% x{c:<4d} {kname[:90]}")
    for ours in OURS:
        per = [_us(e) for e in kernels if f"::{ours}(" in e.name or f"::{ours}<" in e.name]
        if per:
            print(f"[{name}]   per-launch us {ours}: " + " ".join(f"{v:.1f}" for v in per))
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:host_top]
    for a in host:
        print(f"[{name}]   host {a.self_cpu_time_total / 1e3:9.3f} ms x{a.count:<5d} {a.key[:80]}")
    prof.export_chrome_trace(os.path.join(out_dir, f"{name}.json"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "profile"))
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--cells", default=",".join(CELLS))
    args = ap.parse_args(argv)
    cells_on = set(args.cells.split(","))
    import torch

    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device", file=sys.stderr)
        return 1
    import math

    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    import icp_tpu_torch
    from icp_tpu_torch import ICPConfig, icp_symmetric
    from icp_tpu_torch.engine.icp import icp_fixed_iters
    from icp_tpu_torch.engine.plane import run_engine
    from icp_tpu_torch.ops.normals import estimate_normals

    os.makedirs(args.out, exist_ok=True)
    print(chip_smoke.phase_device(), f"package={os.path.dirname(icp_tpu_torch.__file__)}",
          flush=True)
    f32 = dict(dtype=torch.float32, device="cuda")
    if "bf16" in cells_on:
        model = torch.tensor(chip_smoke._load("cow_ref.txt"), **f32)
        scene = torch.tensor(chip_smoke._load("cow_tr1.txt"), **f32)
        profile_cell("cow_sym_bf16", "engine=symmetric nn=bf16",
                     lambda i: float(icp_symmetric(model, scene, ICPConfig(
                         max_iter=i, threshold=-math.inf, nn_method="bf16")).err), 20, args.out)
    if "k5" in cells_on:
        model = torch.tensor(chip_smoke._load("cow_ref.txt"), **f32)
        scene = torch.tensor(chip_smoke._load("cow_tr1.txt"), **f32)
        profile_cell("cow_k5", "engine=point_to_point nn=bcast solver=qcp_fused",
                     lambda i: float(icp_fixed_iters(model, scene, n_iters=i, solver="qcp_fused",
                                                     nn_method="bcast").err), 20, args.out)
    if "trim" in cells_on:
        for name, ref, scene_file, nn, k in (
                ("cow", "cow_ref.txt", "cow_tr1.txt", "pallas", 20),
                ("horse", "horse_ref.txt", "horse_tr1.txt", "grid", 20),
                ("1M", None, None, "grid", 10)):
            if ref is None:
                model, scene, _ = chip_smoke.scale_pair(0)
            else:
                model = torch.tensor(chip_smoke._load(ref), **f32)
                scene = torch.tensor(chip_smoke._load(scene_file), **f32)
            profile_cell(f"{name}_trim", f"engine=point_to_point path={nn} trim=0.1",
                         lambda i: float(icp_fixed_iters(model, scene, n_iters=i,
                                                         solver="qcp_fused", nn_method=nn,
                                                         trim_fraction=0.1).err), k, args.out)
            del model, scene
    if "sharded" in cells_on:
        from icp_tpu_torch import icp_sharded, make_mesh

        mesh = make_mesh()
        for name, nn in (("cow", "pallas"), ("horse", "grid")):
            model = torch.tensor(chip_smoke._load(f"{name}_ref.txt"), **f32)
            scene = torch.tensor(chip_smoke._load(f"{name}_tr1.txt"), **f32)
            for entry, fn in (("single", icp_fixed_iters), ("sharded", None)):
                if fn is None:
                    run = lambda i: float(icp_sharded(model, scene, ICPConfig(
                        max_iter=i, threshold=-math.inf, nn_method=nn), mesh=mesh).err)
                else:
                    run = lambda i: float(fn(model, scene, n_iters=i, solver="qcp_fused",
                                             nn_method=nn).err)
                profile_cell(f"{name}_{entry}", f"engine=point_to_point path={nn} world=1",
                             run, 20, args.out, host_top=12)
        torch.distributed.destroy_process_group()
    cells = [("cow", "cow_ref.txt", "cow_tr1.txt", "pallas", 20),
             ("horse", "horse_ref.txt", "horse_tr1.txt", "grid", 20), ("1M", None, None, "grid", 10)]
    for name, ref, scene_file, nn, k in cells:
        if name not in cells_on:
            continue
        if ref is None:
            model, scene, _ = chip_smoke.scale_pair(0)
        else:
            model = torch.tensor(chip_smoke._load(ref), **f32)
            scene = torch.tensor(chip_smoke._load(scene_file), **f32)
        profile_cell(name, f"engine=point_to_point path={nn}",
                     lambda i: float(icp_fixed_iters(model, scene, n_iters=i, solver="qcp_fused",
                                                     nn_method=nn).err), k, args.out)
        method = "dense" if nn == "pallas" else "grid"
        profile_cell(f"{name}_normals", f"method={method}",
                     lambda _: estimate_normals(model, method=method), 0, args.out)
        normals = estimate_normals(model, method=method)
        scene_normals = estimate_normals(scene, method=method)
        for engine, short in (("point_to_plane", "p2pl"), ("symmetric", "sym"), ("gicp", "gicp")):
            profile_cell(f"{name}_{short}", f"engine={engine} path={nn}",
                         lambda i: float(run_engine(
                             engine, model, scene,
                             ICPConfig(max_iter=i, threshold=-math.inf, nn_method=nn),
                             model_normals=normals, scene_normals=scene_normals).err),
                         k, args.out)
        del model, scene, normals, scene_normals
    return 0


if __name__ == "__main__":
    sys.exit(main())
