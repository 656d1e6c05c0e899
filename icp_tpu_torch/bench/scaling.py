"""Weak scaling of the sharded engine on synthetic clouds (port of
``icp_tpu/bench/scaling.py``).

BASELINE.json config 4: "Synthetic 1M+ point clouds, scene points sharded
across chips with all-gather NN search", target >= 80% weak-scaling
efficiency.  Points a rank are held constant and only the scene grows with
the ranks, so perfect scaling is a constant wall time; efficiency =
t(1 rank) / t(n ranks).  One JSON line a cell.

JAX sweeps the devices of one process.  Here a cell is one process group
(``torch.distributed``, one rank a card): under ``torchrun`` this runs one
cell at the group's size and rank 0 prints it::

    torchrun --standalone --nproc-per-node 4 -m icp_tpu_torch.bench.scaling

and with no group, ``--devices 1 2 4`` starts one ``torchrun`` child a count
(each at most the cards of the host) and adds ``weak_scaling_efficiency``
against the first count.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np


def _progress(msg):
    print(f"[scaling] {msg}", file=sys.stderr, flush=True)


def synthetic_pair(n_model: int, n_scene: int, seed: int = 0):
    """Model cloud + rigidly transformed scene (known ground truth).

    Scene size is independent of model size: weak scaling holds per-device
    work (scene_shard x model) constant by growing ONLY the scene with the
    device count — growing both would double per-device work per doubling
    (brute-force NN is O(N*M)).
    """
    rng = np.random.default_rng(seed)
    model = rng.standard_normal((n_model, 3)).astype(np.float32) * 2.0
    reps = -(-n_scene // n_model)
    base = np.tile(model, (reps, 1))[:n_scene]
    theta = 0.1
    R = np.array(
        [
            [np.cos(theta), -np.sin(theta), 0],
            [np.sin(theta), np.cos(theta), 0],
            [0, 0, 1],
        ],
        np.float32,
    )
    scene = base @ R.T + np.array([0.05, -0.03, 0.08], np.float32)
    return model, scene


def run_cell(n_devices: int, points_per_device: int, n_iters: int, ring: bool,
             model_points: int = 65536, reps: int = 3, device=None):
    """One cell on the process group's mesh (``make_mesh(device)``: the card
    unless ``device="cpu"``, a world-1 group when none exists), which must
    span ``n_devices`` ranks: every rank calls this with the same
    arguments."""
    import torch

    from icp_tpu_torch.bench.harness import wall_time
    from icp_tpu_torch.config import ICPConfig
    from icp_tpu_torch.parallel.mesh import make_mesh
    from icp_tpu_torch.parallel.sharded import icp_sharded

    mesh = make_mesh(device)
    if mesh.size() != n_devices:
        raise ValueError(f"run_cell: the process group has {mesh.size()} ranks, not "
                         f"{n_devices}; start {n_devices} ranks (torchrun) for this cell")
    n = points_per_device * n_devices
    model, scene = synthetic_pair(model_points, n)
    cfg = ICPConfig(
        max_iter=n_iters,
        threshold=0.0,  # run all iterations (throughput measurement)
        dtype=torch.float32,
        solver="qcp_fused" if mesh.device_type == "cuda" else "eigh",
        validate_inputs=False,
    )
    res = None

    def run():
        nonlocal res
        res = icp_sharded(model, scene, cfg, mesh=mesh, ring=ring)
        float(res.err)

    best = wall_time(run, reps=reps)
    return dict(
        devices=n_devices,
        points=n,
        points_per_device=points_per_device,
        iters=n_iters,
        wall_s=best,
        iter_per_s=n_iters / best,
        point_iter_per_s=n * n_iters / best,
        ring=ring,
        err=float(res.err),
    )


def _cell_args(args) -> list[str]:
    return ["--points-per-device", str(args.points_per_device), "--model-points",
            str(args.model_points), "--iters", str(args.iters), "--device", args.device,
            "--ring" if args.ring else "--all-gather"]


def _spawn_cell(d: int, args) -> dict:
    """One ``torchrun`` child of ``d`` ranks; its rank 0's JSON line."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(d), "-m", "icp_tpu_torch.bench.scaling", *_cell_args(args)]
    out = subprocess.run(cmd, capture_output=True, text=True, check=False)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    if out.returncode != 0 or not lines:
        raise RuntimeError(f"the {d}-rank cell failed (rc {out.returncode}):\n"
                           f"{out.stderr[-3000:]}")
    return json.loads(lines[-1])


def main(argv=None) -> int:
    import torch
    import torch.distributed as dist

    ap = argparse.ArgumentParser(prog="icp-scaling-torch")
    ap.add_argument("--points-per-device", type=int, default=65536)
    ap.add_argument("--model-points", type=int, default=65536)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--ring", action="store_true", default=True)
    ap.add_argument("--all-gather", dest="ring", action="store_false")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument(
        "--devices", type=int, nargs="*", default=None,
        help="rank counts to sweep, one torchrun child each (default: 1, 2, 4, ... up "
             "to the host's cards); ignored under torchrun",
    )
    args = ap.parse_args(argv)

    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        try:
            cell = run_cell(world, args.points_per_device, args.iters, args.ring,
                            model_points=args.model_points, device=args.device)
            if dist.get_rank() == 0:
                print(json.dumps(cell), flush=True)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        return 0

    n_avail = torch.cuda.device_count() if args.device == "cuda" else os.cpu_count()
    if not n_avail:
        raise SystemExit("icp-scaling-torch: no CUDA device; pass --device cpu")
    counts = args.devices or [d for d in (1, 2, 4, 8) if d <= n_avail]
    too_many = [d for d in counts if d > n_avail]
    if too_many:
        raise SystemExit(f"icp-scaling-torch: {too_many} ranks asked for, "
                         f"{n_avail} {args.device} devices here")
    base = None
    for d in counts:
        _progress(f"devices={d} points={args.points_per_device * d} ...")
        cell = _spawn_cell(d, args)
        if base is None:
            base = cell["wall_s"]
        cell["weak_scaling_efficiency"] = round(base / cell["wall_s"], 3)
        print(json.dumps(cell), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
