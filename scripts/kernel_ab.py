#!/usr/bin/env python3
"""Time K4 (kd-tile NN) and K6 (dense kNN) of one checkout on one CUDA card.

    python3 scripts/kernel_ab.py [--root DIR] [--label NAME]

``--root`` names the checkout whose ``icp_tpu_torch`` is measured (default:
this one), so two versions can be timed in one call on one card, in turns
(parent, change, change, parent).  The tables and clouds come from this
checkout's ``chip_smoke.py`` and ``data/``:

  * K4 on horse's first-iteration candidate table (capacity 16 and 1, and
    with the 3-wide normals payload), and on the 1,000,000-point pair's
    first- and third-iteration tables;
  * K6 at cow (2,903^2) and horse (48,485^2) with k 17, cow with k 32, and
    a lattice of equal distances (4,096 x 8,192, k 17);
  * the point-to-point grid loop's ms/iter at horse and at 1M.

Kernel times are medians of CUDA events; loop times are host clocks around
runs that end in ``torch.cuda.synchronize()``, the difference of two
iteration counts.  Prints one JSON line, with the card's name and power limit, and exits 1
without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    cs = _smoke()
    from icp_tpu_torch.engine.grid import _prepare_scene
    from icp_tpu_torch.engine.icp import icp_fixed_iters
    from icp_tpu_torch.kernels import knn_dense, nn_grid
    from icp_tpu_torch.ops.normals import estimate_normals

    import icp_tpu_torch

    out = {"label": args.label, "package": os.path.dirname(icp_tpu_torch.__file__),
           "card": cs.phase_device()}
    f32 = dict(dtype=torch.float32, device="cuda")

    def k4_ms(grid, p, u, tn, cap, payload=False, reps=20):
        cand, counts, _ = nn_grid.candidates(p, u, grid, scene_tile=tn, cap=cap)
        kw = {"kd_row": grid.kd_row} if hasattr(grid, "kd_row") else {}
        a = (cand, counts, p, grid.tiles, tn, grid.payload if payload else None)
        return {"ms": cs.cuda_ms(lambda: nn_grid.nn_grid(*a, **kw), reps),
                "fallback_tiles": int((counts > cap).sum()),
                "mean_count": round(counts.double().mean().item(), 3)}

    def loop_ms(model, scene, k):
        def run(i):
            return cs._wall(lambda: float(icp_fixed_iters(model, scene, n_iters=i,
                                                          solver="qcp_fused",
                                                          nn_method="grid").err))
        run(2)
        t1 = statistics.median(run(1) for _ in range(3))
        tk = statistics.median(run(k + 1) for _ in range(3))
        return (tk - t1) / k * 1e3

    horse_ref = torch.tensor(cs._load("horse_ref.txt"), **f32)
    horse_tr1 = torch.tensor(cs._load("horse_tr1.txt"), **f32)
    cow_ref = torch.tensor(cs._load("cow_ref.txt"), **f32)
    p0, _, _, tn, _ = _prepare_scene(horse_tr1, 256)
    p0 = p0.contiguous()
    normals = estimate_normals(horse_ref, method="dense")
    grid = nn_grid.build_model_grid(horse_ref, target_tile=1024, payload=normals)
    u0 = nn_grid.bound_from_indices(p0, grid, nn_grid.initial_bound_indices(p0, horse_ref))
    out["k4_horse_cap16"] = k4_ms(grid, p0, u0, tn, 16)
    out["k4_horse_cap1"] = k4_ms(grid, p0, u0, tn, 1)
    out["k4_horse_payload"] = k4_ms(grid, p0, u0, tn, 16, payload=True)

    lat_q, lat_p = cs.tied_lattice(6)
    for label, q, pts, k, reps in (("cow", cow_ref, cow_ref, 17, 20),
                                   ("horse", horse_ref, horse_ref, 17, 5),
                                   ("cow_k32", cow_ref, cow_ref, 32, 20),
                                   ("lattice", lat_q, lat_p, 17, 20)):
        out[f"k6_{label}_ms"] = cs.cuda_ms(lambda: knn_dense.knn_dense(q, pts, k), reps)
    out["horse_p2p_ms_per_iter"] = loop_ms(horse_ref, horse_tr1, 20)
    del grid, p0, u0, normals

    model, scene, _ = cs.scale_pair(0)
    mgrid, mtn, states = cs.grid_loop_states(model, scene, 3)
    for label, (p, u) in (("first", states[0]), ("third", states[2])):
        out[f"k4_1M_{label}"] = k4_ms(mgrid, p, u, mtn, 16, reps=10)
    del mgrid, states
    out["1M_p2p_ms_per_iter"] = loop_ms(model, scene, 9)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
