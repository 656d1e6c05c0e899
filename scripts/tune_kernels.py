#!/usr/bin/env python3
"""K7 for several work-item sizes on one CUDA card, and the kernels' SASS.

    python3 scripts/tune_kernels.py [--sass FILE]

Prints one JSON line: K7 (kd-tile kNN, k 17) on the seed and exact tables
of the horse and the 1M model's normals with
``kernels.knn_grid.TILES_PER_ITEM`` 2, 8 and 16 (the model tiles of a
work item), each launch first held bit for bit against its plain version
(every horse tile, 68 sampled 1M tiles); times are medians of CUDA
events.  ``--sass`` writes ``cuobjdump -sass`` of the built library to
FILE, for counting a kernel's instructions.  ``scripts/kernel_ab.py``
times the kept design against another checkout.  Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("tune_kernels: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from icp_tpu_torch.engine.grid import _prepare_scene
    from icp_tpu_torch.kernels import _build, knn_grid, nn_grid

    out = {"card": cs.phase_device()}
    cs.phase_build()
    if args.sass:
        cuobjdump = os.path.join(os.path.dirname(os.path.dirname(_build._nvcc())), "bin",
                                 "cuobjdump")
        with open(args.sass, "w") as f:
            subprocess.run([cuobjdump, "-sass", _build.build_info["path"]], stdout=f, check=True)
    f32 = dict(dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(1)

    def load(name):
        return torch.tensor(cs._load(name), **f32)

    horse_ref = load("horse_ref.txt")
    model, _, _ = cs.scale_pair(0)
    default_per = knn_grid.TILES_PER_ITEM
    for name, cloud in (("horse", horse_ref), ("1M", model)):
        grid = nn_grid.build_model_grid(cloud, target_tile=256)
        q, _, _, tn, _ = _prepare_scene(cloud, 64)
        q = q.contiguous()
        bd2 = nn_grid.tile_box_dists(q, grid, scene_tile=tn)
        seed = knn_grid.seed_table(bd2, 17, grid.model_tile)
        kth = knn_grid.knn_worklist(*seed, q, grid.tiles, tn, 17)[0][:, 16].contiguous()
        tables = {"seed": (seed, None), "exact": (knn_grid.cull_table(bd2, kth, tn, 32), kth)}
        del bd2
        for label, ((cand, counts), kb) in tables.items():
            if name == "horse":
                sel = torch.arange(cand.shape[0], device="cuda")
            else:
                fall = torch.nonzero(counts > cand.shape[1]).flatten()[:4]
                pick = torch.tensor(rng.choice(cand.shape[0], 64, replace=False), device="cuda")
                sel = torch.unique(torch.cat([pick, fall]))
            srows = (sel[:, None] * tn + torch.arange(tn, device="cuda")).flatten()
            dp, ip = knn_grid.knn_worklist_plain(
                cand[sel].contiguous(), counts[sel].contiguous(), q[srows].contiguous(),
                grid.tiles, tn, 17, None if kb is None else kb[srows].contiguous())
            args_ = (cand, counts, q, grid.tiles, tn, 17)
            for per in (2, 8, 16):
                if label == "seed" and per > 2:
                    continue  # a seed list is 2 tiles: one item from 2 up
                knn_grid.TILES_PER_ITEM = per
                dk, ik = knn_grid.knn_worklist(*args_, bound=kb)
                cs.require(torch.equal(ik[srows], ip) and torch.equal(dk[srows], dp),
                           f"K7 {name} {label} tiles_per_item={per}")
                out[f"k7_{name}_{label}_tiles{per}_ms"] = cs.cuda_ms(
                    lambda: knn_grid.knn_worklist(*args_, bound=kb), 5 if name == "1M" else 10)
            knn_grid.TILES_PER_ITEM = default_per
        del grid, q, tables
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
