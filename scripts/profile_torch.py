#!/usr/bin/env python3
"""Where the time goes in the port's loops, on one CUDA card.

    python3 scripts/profile_torch.py [--out DIR]

For each cell — cow_tr1 on the fused path (K3 + K2), horse_tr1 on the grid
path (K4 + torch + K2), and the 1,000,000-point pair of ``chip_smoke.py``
on the grid path — it times fixed-iteration loops without the profiler
(ms/iter from the difference of two iteration counts), then runs one loop
under ``torch.profiler`` and prints the device time by kernel, the device's
busy share of the profiled window (union of kernel intervals over the
window's wall time) and each launch's time of the hand-written kernels.
Chrome traces go to ``DIR`` (default ``chiprun_out/profile``).
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OURS = ("nn_dense_kernel", "qcp_step_kernel", "icp_fused_kernel", "nn_grid_kernel")


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


def profile_cell(name, model, scene, nn, n_iters, out_dir):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from icp_tpu_torch.engine.icp import icp_fixed_iters

    def run(k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(icp_fixed_iters(model, scene, n_iters=k, solver="qcp_fused", nn_method=nn).err)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(2)
    t1 = statistics.median(run(1) for _ in range(3))
    tk = statistics.median(run(n_iters + 1) for _ in range(3))
    print(f"[{name}] path={nn} ms_per_iter={(tk - t1) / n_iters * 1e3:.4f} "
          f"setup_plus_one_iter_ms={t1 * 1e3:.3f}", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run(n_iters)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    total = sum(_us(e) for e in kernels) or float("nan")
    print(f"[{name}] profiled iters={n_iters} wall_ms={wall * 1e3:.3f} "
          f"device_kernel_ms={total / 1e3:.3f} "
          f"device_busy_share={_busy_share(kernels, wall * 1e6):.3f} "
          f"kernel_launches={len(kernels)}", flush=True)
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + _us(e), c + 1)
    for kname, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"[{name}]   {t / 1e3:9.3f} ms {100 * t / total:5.1f}% x{c:<4d} {kname[:90]}")
    for ours in OURS:
        per = [_us(e) for e in kernels if ours in e.name]
        if per:
            print(f"[{name}]   per-launch us {ours}: " + " ".join(f"{v:.1f}" for v in per))
    prof.export_chrome_trace(os.path.join(out_dir, f"{name}.json"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "profile"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    os.makedirs(args.out, exist_ok=True)
    print(chip_smoke.phase_device(), flush=True)
    f32 = dict(dtype=torch.float32, device="cuda")
    for name, ref, scene, nn, k in (("cow", "cow_ref.txt", "cow_tr1.txt", "pallas", 20),
                                    ("horse", "horse_ref.txt", "horse_tr1.txt", "grid", 20)):
        profile_cell(name, torch.tensor(chip_smoke._load(ref), **f32),
                     torch.tensor(chip_smoke._load(scene), **f32), nn, k, args.out)
    model, scene, _ = chip_smoke.scale_pair(0)
    profile_cell("1M", model, scene, "grid", 10, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
