#!/usr/bin/env python3
"""K7 for several work-item sizes, K8 for several shapes of its fold, on one
CUDA card, and the kernels' SASS.

    python3 scripts/tune_kernels.py [--sections k7,k8] [--sass FILE]

Prints one JSON line.  ``k7``: K7 (kd-tile kNN, k 17) on the seed and
exact tables of the horse and the 1M model's normals with
``kernels.knn_grid.TILES_PER_ITEM`` 2, 8 and 16 (the model tiles of a
work item), each launch first held bit for bit against its plain version
(every horse tile, 68 sampled 1M tiles); times are medians of CUDA
events.  ``k8``: ``csrc/nn_chunked.cu`` built again with other values of
its constants (threads a block, scene points a warp, rows a stage, a
lane's rows a group, ring stages, a chunk's rows at least; ``K8_VARIANTS``),
one library each under ``build/tune_k8/``, each launch held bit for bit against K1's indices at
cow (2,903^2), the grid seed (49,152 x 3,031) and the 1M seed (1,015,808 x
62,500) with its workspace clean after it, then timed: device
microseconds a call from ``torch.profiler`` and CUDA-event milliseconds.
``--sass`` writes ``cuobjdump -sass`` of the built library to FILE, for
counting a kernel's instructions.  ``scripts/kernel_ab.py`` times the kept
design against another checkout.  Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# K8 variants: name -> (threads a block, scene points a warp, model rows a
# stage, a lane's rows a group, ring stages, a chunk's model rows at least)
K8_VARIANTS = {
    "t256_p8_s512_g4_r1024": (256, 8, 512, 4, 4, 1024),
    "t256_p8_s512_g4_r1": (256, 8, 512, 4, 4, 1),
    "t256_p8_s512_g4_r960": (256, 8, 512, 4, 4, 960),
    "t256_p8_s512_g4_r2048": (256, 8, 512, 4, 4, 2048),
    "t128_p8_s512_g4_r1": (128, 8, 512, 4, 4, 1),
    "t128_p8_s512_g1_r1": (128, 8, 512, 1, 4, 1),
    "t128_p8_s128_g4_r1": (128, 8, 128, 4, 4, 1),
}
_K8_CONSTANTS = ("kThreads", "kPoints", "kStageRows", "kGroup", "kStages", "kMinChunkRows")


def build_k8_variants(nvcc: str, flags: list, csrc: str) -> dict:
    """name -> ctypes library of each K8 variant, built in parallel."""
    with open(os.path.join(csrc, "nn_chunked.cu")) as f:
        source = f.read()
    out_dir = os.path.join(ROOT, "build", "tune_k8")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name, values in K8_VARIANTS.items():
        src = source
        for const, v in zip(_K8_CONSTANTS, values):
            src, hits = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {v};",
                                src)
            assert hits == 1, const
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        so = os.path.join(out_dir, f"lib{name}.so")
        jobs[name] = (so, subprocess.Popen([nvcc, *flags, "-shared", "-I", csrc, "-o", so, path],
                                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for K8 {name}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.nn_chunked_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.nn_chunked_workspace.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.nn_chunked_chunk_rows.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        regs = re.findall(r"Used (\d+) registers", log)
        frames = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores", log)
        libs[name] = (lib, {"registers": int(regs[0]) if regs else None,
                            "stack_spill": frames[0] if frames else None})
    return libs


def k8_section(cs, out: dict) -> None:
    """Every K8 variant at cow, the grid seed and the 1M seed."""
    import torch

    from icp_tpu_torch.engine.grid import _prepare_scene
    from icp_tpu_torch.kernels import _build, nn_dense

    f32 = dict(dtype=torch.float32, device="cuda")
    horse_ref = torch.tensor(cs._load("horse_ref.txt"), **f32)
    model, scene, _ = cs.scale_pair(0)
    shapes = {"cow": (torch.tensor(cs._load("cow_tr1.txt"), **f32),
                      torch.tensor(cs._load("cow_ref.txt"), **f32)),
              "grid_seed": (_prepare_scene(torch.tensor(cs._load("horse_tr1.txt"), **f32),
                                           256)[0].contiguous(), horse_ref[::16].contiguous()),
              "1M_seed": (_prepare_scene(scene, 256)[0].contiguous(), model[::16].contiguous())}
    del model, scene
    want = {k: nn_dense.nn_dense(s, m) for k, (s, m) in shapes.items()}
    libs = build_k8_variants(_build._nvcc(), _build.NVCC_FLAGS, _build.CSRC_DIR)
    for name, (lib, info) in libs.items():
        points, blocks = ctypes.c_int(), ctypes.c_int()
        _build.check(lib.nn_chunked_workspace(ctypes.addressof(points), ctypes.addressof(blocks)),
                     name)
        keys = torch.full((points.value,), -1, dtype=torch.int64, device="cuda")
        counts = torch.zeros(blocks.value, dtype=torch.int32, device="cuda")
        row = dict(info)
        for label, (s, m) in shapes.items():
            idx = torch.empty(s.shape[0], dtype=torch.int32, device="cuda")

            def launch(lib=lib, s=s, m=m, idx=idx):
                _build.check(lib.nn_chunked_launch(
                    s.data_ptr(), s.shape[0], m.data_ptr(), m.shape[0], keys.data_ptr(),
                    counts.data_ptr(), keys.shape[0], idx.data_ptr(), _build.stream_ptr(s)), name)

            launch()
            cs.require(torch.equal(idx, want[label]), f"K8 {name} {label}: differs from K1")
            cs.require(bool((keys == -1).all()) and not bool(counts.any()),
                       f"K8 {name} {label}: workspace not clean")
            rows = ctypes.c_int()
            _build.check(lib.nn_chunked_chunk_rows(s.shape[0], m.shape[0],
                                                   ctypes.addressof(rows)), name)
            row[f"{label}_chunks"] = -(-m.shape[0] // rows.value)
            reps = 3 if label == "1M_seed" else 20
            row[f"{label}_device_us"] = round(cs.device_us(launch, ("nn_chunked",), reps),
                                              2)
            row[f"{label}_ms"] = round(cs.cuda_ms(launch, reps), 4)
        out[f"k8_{name}"] = row
        print(json.dumps({name: row}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", default=None)
    ap.add_argument("--sections", default="k7")
    args = ap.parse_args(argv)
    sections = set(args.sections.split(","))
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
    if "k8" in sections:
        k8_section(cs, out)
    if "k7" not in sections:
        print(json.dumps(out), flush=True)
        return 0
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
