#!/usr/bin/env python3
"""Measure, on one CUDA card, both sides of each size at which the port's
``"auto"`` dispatch changes path, and hold the two sides' answers against
each other.

    python3 scripts/dispatch_sweep.py [--sections p2p,plane,normals,chain]
                                      [--out chiprun_out/dispatch_sweep.jsonl]
    python3 scripts/dispatch_sweep.py --sections grid --out chiprun_out/grid_sweep.jsonl

Sections (one JSON line a measurement on stdout and in ``--out``, each
with the card's ``nvidia-smi --query-gpu=name,power.limit`` line):

  * ``p2p``: ``icp_fixed_iters`` with ``solver="qcp_fused"`` on equal
    clouds of ``SIZES`` points (horse subsampled below 48,485 rows, horse
    itself, ``chip_smoke.scale_pair_np``'s upsampled horse above), each
    size on three sides, timed as ``bench.harness.loop_per_iter`` times
    them: ``pipeline`` (K1, float64 sums, K2: the fused path disabled),
    ``fused`` (K3, its model caps lifted past the size) and ``grid``
    (K1's seed, K4, K2);
  * ``plane``: ``icp_point_to_plane`` (fixed iterations, the model's
    normals given) on the same clouds, ``nn_method`` ``"pallas"`` against
    ``"grid"``;
  * ``normals``: ``knn_indices(..., k=17)`` with K6 (``"dense"``) and K7
    (``"grid"``) on horse subsampled to ``NORMAL_SIZES`` rows and whole;
  * ``chain``: ``register_chain`` on the five bunny scans at
    ``icp-slam-torch``'s defaults, with the bucket JAX's "auto" gives the
    chain and with none, on the grid, the pipeline and K3.
  * ``grid`` (not in the default list): the kd-grid's sizes, searched by
    coordinates from JAX's (``GRID_AXES``: the candidate capacity, then the
    scene tile, the model tile and K1's seed stride; ``NORMALS_AXES`` for
    K7) on point-to-point (``_icp_grid`` in fixed mode, ``qcp_fused``),
    point-to-plane and ``knn_indices(k=17, method="grid")`` at the
    ``GRID_CELLS`` sizes; then, at every size, JAX's sizes against the
    package's own on the device and the search's best at the largest size
    (``confirm``).  Each setting's line carries its tables (K4's at the
    first and third iteration, K7's seed and exact pass: ``ni``, ``nj``,
    tiles past the capacity, folded pairs), its peak memory and its
    agreement with the run at JAX's sizes (``GRID_P2P_ATOL``,
    ``GRID_PLANE_ATOL``); a setting that does not hold is never the best.

Times are ``(t(big) - t(small)) / (big - small)`` by host wall (ms an
iteration), ``t(small)`` with ``small = 1`` being set-up plus the first
iteration, each the best of ``REPS`` runs; three passes, the sides
interleaved in each, best and spread (largest less smallest pass) beside
each other.  Agreement (``agree``
lines): each side's converged run (``icp``) against the pipeline's (or,
for the plane, the dense run's; for the chain, the unbucketed pipeline's):
iterations, error and the largest gap of the points; at horse every p2p
side is also held to the reference binary's horse_tr1 fixture (3
iterations, trace rtol 1e-2, output 2e-6).  Each side's launches (the
counts set to 0 just before one short run) show the path it took.
``--device cpu`` rehearses the control flow on the plain versions at the
sizes given by ``--sizes``; its lines carry ``"device": "cpu"`` and no
card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

SIZES = (4096, 8192, 16384, 32768, 48485, 65536, 131072, 262144)
NORMAL_SIZES = (2048, 4096, 8192, 16384, 32768, 48485, 65536, 131072, 262144)
HORSE = 48485
PASSES = 3
REPS = 5  # runs of each iteration count in a pass, the best taken (the grid's are host-bound)
SEED = 0


def card_line(device: str) -> str | None:
    if device != "cuda":
        return None
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


class Out:
    """One JSON object a line, on stdout and in the output file."""

    def __init__(self, path: str, device: str):
        import torch

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.f = open(path, "w")
        self.common = {"card": card_line(device),
                       "device": torch.cuda.get_device_name(0) if device == "cuda" else "cpu"}

    def __call__(self, **rec) -> dict:
        line = json.dumps({**rec, **self.common})
        print(line, flush=True)
        self.f.write(line + "\n")
        self.f.flush()
        return rec

    def close(self) -> None:
        self.f.close()


@contextlib.contextmanager
def attr(module, name: str, value):
    """``module.name`` set to ``value`` within the body, put back after."""
    orig = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def fused_lifted():
    """K3 at any model size: ``fused_path_available`` reads its caps from
    its module at each call."""
    from icp_tpu_torch.kernels import icp_fused

    with attr(icp_fused, "MAX_FUSED_MODEL", 1 << 62), \
            attr(icp_fused, "MAX_FUSED_MODEL_CUDA", 1 << 62):
        yield


def pair(n: int, device: str):
    """(model, scene) float32 on ``device``: horse's rows (the same seeded
    subset of horse_ref and horse_tr1 below 48,485 rows), else the scaled
    pair's recipe at ``n`` points."""
    import numpy as np
    import torch

    if n <= HORSE:
        model_np, scene_np = cs._load("horse_ref.txt"), cs._load("horse_tr1.txt")
        if n < HORSE:
            rows = np.sort(np.random.default_rng(SEED).choice(HORSE, n, replace=False))
            model_np, scene_np = model_np[rows], scene_np[rows]
    else:
        model_np, scene_np, _ = cs.scale_pair_np(SEED, n)
    f32 = dict(dtype=torch.float32, device=device)
    return torch.tensor(model_np, **f32), torch.tensor(scene_np, **f32)


def launches(run) -> dict:
    """The kernels ``run()`` launched (counts set to 0 just before)."""
    import torch

    from icp_tpu_torch.kernels import _build

    _build.reset_counts()
    run()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {k: v for k, v in _build.LAUNCHES.items() if v}


def timed_passes(sides: dict) -> dict:
    """side -> (passes of ms an iteration, passes of set-up + first ms):
    ``PASSES`` passes of each side's timer (``(seconds an iteration,
    seconds of the small run)``, as ``harness.differenced`` gives them),
    the sides interleaved in each pass."""
    out = {s: ([], []) for s in sides}
    for _ in range(PASSES):
        for s, timer in sides.items():
            per, first = timer()
            out[s][0].append(per * 1e3)
            out[s][1].append(first * 1e3)
    return out


def summarize(passes: list) -> dict:
    best = min(passes)
    return {"ms": round(best, 6), "spread_ms": round(max(passes) - best, 6),
            "passes_ms": [round(p, 6) for p in passes]}


def verdict(times: dict, a: str, b: str) -> dict:
    """Which of ``a`` and ``b`` is faster, and whether by more than the
    larger spread of the two sides' passes."""
    ta, tb = times[a], times[b]
    fast, slow = (a, b) if ta["ms"] <= tb["ms"] else (b, a)
    margin = times[slow]["ms"] - times[fast]["ms"]
    spread = max(ta["spread_ms"], tb["spread_ms"])
    return {"faster": fast, "margin_ms": round(margin, 6), "beyond_spread": margin > spread}


def crossover(rows: list, a: str, b: str):
    """The least size from which ``b`` is faster than ``a`` beyond the
    spread at that size and every larger one (None: at no size)."""
    cross = None
    for n, v in sorted(rows, reverse=True):
        if v["faster"] == b and v["beyond_spread"]:
            cross = n
        else:
            break
    return cross


def iters_for(n: int) -> tuple:
    return (1, 11) if n > 65536 else (1, 21)


def gap(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def hold_horse_fixture(trace) -> dict:
    """The reference binary's horse_tr1 run (3 iterations) against
    ``trace``: the relative gap of its trace (entries > 1e-6) and the
    largest output gap, and whether both are within 1e-2 and 2e-6."""
    import numpy as np

    from icp_tpu_torch.io.csv import load_matrix

    want = cs._golden(os.path.join(cs.FIXDIR, "horse_tr1_stderr.txt"))
    got = trace.errs[:int(trace.result.iters)].tolist()
    with contextlib.redirect_stderr(io.StringIO()):
        gold = load_matrix(os.path.join(cs.FIXDIR, "horse_tr1_output.txt"))
    pts = trace.result.points.double().cpu().numpy()
    rel = max(abs(g - w) / w for g, w in zip(got, want) if w > 1e-6) \
        if len(got) == len(want) else math.inf
    off = np.abs(pts - gold)
    return {"fixture_iters": len(got), "fixture_trace_rel": rel,
            "fixture_output_gap": float(off.max()),
            "fixture_held": len(got) == len(want) == 3 and rel <= cs.TRACE_RTOL
            and bool(np.all(off <= 2e-6 + 1e-7 * np.abs(gold)))}


def section_p2p(out: Out, sizes, device: str) -> list:
    from icp_tpu_torch import ICPConfig, icp
    from icp_tpu_torch.bench.harness import fused_path_disabled, loop_per_iter
    from icp_tpu_torch.engine.icp import icp_fixed_iters

    # side -> (the fused gate, loop_per_iter's path)
    gates = {"pipeline": (fused_path_disabled, "pipeline"), "fused": (fused_lifted, "fused"),
             "grid": (contextlib.nullcontext, "grid")}
    rows = []
    for n in sizes:
        model, scene = pair(n, device)
        small, big = iters_for(n)

        def timer(side):
            ctx, path = gates[side]
            with ctx():
                return loop_per_iter(model, scene, path, small, big, reps=REPS)

        def short(side):
            with gates[side][0]():
                float(icp_fixed_iters(model, scene, n_iters=2, solver="qcp_fused",
                                      nn_method="grid" if side == "grid" else "pallas").err)

        paths = {s: launches(lambda s=s: short(s)) for s in gates}
        if device == "cuda":
            p = paths
            cs.require(p["pipeline"].get("nn_dense") and not p["pipeline"].get("icp_fused"),
                       f"p2p {n}: pipeline launches {p['pipeline']}")
            cs.require(p["fused"].get("icp_fused") and not p["fused"].get("nn_dense"),
                       f"p2p {n}: fused launches {p['fused']}")
            cs.require(p["grid"].get("nn_grid") and not p["grid"].get("icp_fused"),
                       f"p2p {n}: grid launches {p['grid']}")
        t = timed_passes({s: lambda s=s: timer(s) for s in gates})
        times = {s: summarize(t[s][0]) for s in gates}
        for s in gates:
            out(section="p2p", n=n, side=s, iters=(small, big), **times[s],
                setup_plus_first_ms=round(min(t[s][1]), 6), launches_2_iters=paths[s])
        # agreement: each side's converged run against the pipeline's
        runs = {}
        for s, (ctx, _) in gates.items():
            nn = "grid" if s == "grid" else "pallas"
            with ctx():
                runs[s] = icp(model, scene, ICPConfig(max_iter=30, solver="qcp_fused",
                                                      nn_method=nn), trace=True)
                fixture = hold_horse_fixture(icp(model, scene, ICPConfig(
                    max_iter=3, solver="qcp_fused", nn_method=nn), trace=True)) \
                    if n == HORSE else {}
            ref, r = runs["pipeline"].result, runs[s].result
            out(section="agree_p2p", n=n, side=s, against="pipeline", iters=int(r.iters),
                iters_against=int(ref.iters), err=float(r.err), err_against=float(ref.err),
                max_point_gap=gap(r.points, ref.points), **fixture)
        v = {"pipeline_vs_grid": verdict(times, "pipeline", "grid"),
             "fused_vs_grid": verdict(times, "fused", "grid"),
             "pipeline_vs_fused": verdict(times, "pipeline", "fused")}
        out(section="p2p_verdict", n=n, **v)
        rows.append((n, v))
    return rows


def section_plane(out: Out, sizes, device: str) -> list:
    from icp_tpu_torch import ICPConfig
    from icp_tpu_torch.bench.harness import differenced
    from icp_tpu_torch.engine.point_to_plane import icp_point_to_plane
    from icp_tpu_torch.ops.normals import estimate_normals

    rows = []
    for n in sizes:
        model, scene = pair(n, device)
        normals = estimate_normals(model, k=16)
        small, big = iters_for(n)

        def run_fn(nn):
            def run(k):
                cfg = ICPConfig(max_iter=k, threshold=-math.inf, nn_method=nn)
                float(icp_point_to_plane(model, scene, cfg, normals=normals).err)
            return run

        sides = {"dense": run_fn("pallas"), "grid": run_fn("grid")}
        paths = {s: launches(lambda s=s: sides[s](2)) for s in sides}
        if device == "cuda":
            cs.require(paths["dense"].get("nn_dense") and not paths["dense"].get("nn_grid"),
                       f"plane {n}: dense launches {paths['dense']}")
            cs.require(paths["grid"].get("nn_grid"), f"plane {n}: grid launches {paths['grid']}")
        t = timed_passes({s: lambda s=s: differenced(sides[s], small, big, REPS)
                          for s in sides})
        times = {s: summarize(t[s][0]) for s in sides}
        for s in sides:
            out(section="plane", n=n, side=s, iters=(small, big), **times[s],
                setup_plus_first_ms=round(min(t[s][1]), 6), launches_2_iters=paths[s])
        runs = {s: icp_point_to_plane(model, scene, ICPConfig(max_iter=30, nn_method=nn),
                                      normals=normals)
                for s, nn in (("dense", "pallas"), ("grid", "grid"))}
        for s, r in runs.items():
            out(section="agree_plane", n=n, side=s, against="dense", iters=int(r.iters),
                iters_against=int(runs["dense"].iters), err=float(r.err),
                err_against=float(runs["dense"].err),
                max_point_gap=gap(r.points, runs["dense"].points))
        v = verdict(times, "dense", "grid")
        out(section="plane_verdict", n=n, dense_vs_grid=v)
        rows.append((n, v))
    return rows


def section_normals(out: Out, sizes, device: str) -> list:
    from icp_tpu_torch.bench.harness import wall_time
    from icp_tpu_torch.ops.normals import knn_indices

    rows = []
    for n in sizes:
        model, _ = pair(n, device)
        idx = {m: knn_indices(model, cs.NORMAL_K, method=m) for m in ("dense", "grid")}
        paths = {m: launches(lambda m=m: knn_indices(model, cs.NORMAL_K, method=m))
                 for m in idx}
        if device == "cuda":
            cs.require(paths["dense"].get("knn_dense") and not paths["dense"].get("knn_grid"),
                       f"normals {n}: dense launches {paths['dense']}")
            cs.require(paths["grid"].get("knn_grid"), f"normals {n}: grid launches {paths['grid']}")
        t = {m: [] for m in idx}
        for _ in range(PASSES):
            for m in idx:
                t[m].append(wall_time(lambda m=m: knn_indices(model, cs.NORMAL_K, method=m),
                                      reps=REPS) * 1e3)
        times = {m: summarize(t[m]) for m in idx}
        rows_differ = int((idx["dense"] != idx["grid"]).any(dim=1).sum())
        for m in idx:
            out(section="normals", n=n, side=m, k=cs.NORMAL_K, **times[m], launches=paths[m])
        v = verdict(times, "dense", "grid")
        out(section="normals_verdict", n=n, dense_vs_grid=v, rows_differ=rows_differ)
        rows.append((n, v))
    return rows


def section_chain(out: Out, device: str, subsample: int) -> dict:
    import torch

    from icp_tpu_torch import ICPConfig
    from icp_tpu_torch.bench.harness import _wall, fused_path_disabled
    from icp_tpu_torch.ops.padding import resolve_auto_bucket
    from icp_tpu_torch.ops.transform import apply_similarity
    from icp_tpu_torch.slam.pairwise import register_chain

    clouds = [cs._load(f"{b}.txt")[::subsample] for b in cs.BUNNY]
    null = contextlib.nullcontext
    # (NN method, the fused gate) of each side; the bucket JAX's "auto"
    # gives the chain (its rule, which the CPU keeps) or none
    sides = {"grid": ("grid", null), "pipeline": ("pallas", fused_path_disabled),
             "fused": ("pallas", fused_lifted)}
    quantum = resolve_auto_bucket(clouds, "cpu")
    cases = [(s, b) for s in sides for b in (quantum, None)]
    results, t = {}, {c: [] for c in cases}

    def run(case):
        nn, ctx = sides[case[0]]
        cfg = ICPConfig(max_iter=60, threshold=1e-5, with_scale=False, validate_inputs=False,
                        nn_method=nn)
        with ctx():
            results[case] = register_chain(clouds, cfg, bucket_quantum=case[1], device=device)

    paths = {c: launches(lambda c=c: run(c)) for c in cases}
    for _ in range(PASSES):
        for c in cases:
            t[c].append(_wall(lambda c=c: run(c)) * 1e3)
    ref = results[("pipeline", None)]
    like = ref[0].transform.R
    scenes = [torch.tensor(c, dtype=like.dtype, device=like.device) for c in clouds[1:]]
    times = {}
    for c in cases:
        times[c] = summarize(t[c])
        pairs = results[c]
        gaps = [gap(apply_similarity(s, p.transform), apply_similarity(s, q.transform))
                for s, p, q in zip(scenes, pairs, ref)]
        out(section="chain", side=c[0], bucket=c[1], rows=[len(x) for x in clouds],
            **{k.replace("ms", "ms_a_chain"): v for k, v in times[c].items()},
            pair_iters=[p.iters for p in pairs], pair_errs=[p.err for p in pairs],
            against="pipeline unbucketed",
            max_point_gap_per_pair=gaps, launches=paths[c])
    return times


# The grid section: the kd-grid's sizes.  JAX's (TPU) values, the start of
# every search; the coordinates searched in order, each at the best held
# value of those before it (the plane engines' grid loop takes no seed
# stride of its caller, so its search stops at the model tile).
JAX_GRID = {"scene_tile": 256, "model_tile": 1024, "max_candidates": 16, "bound_stride": 16}
JAX_NORMALS = {"scene_tile": 64, "model_tile": 256, "max_candidates": 32}
GRID_AXES = (("max_candidates", (16, 32, 64, 128, 256)),
             ("scene_tile", (64, 128, 256, 512, 1024)),
             ("model_tile", (256, 512, 1024, 2048, 4096)),
             ("bound_stride", (4, 8, 16, 32, 64)))
NORMALS_AXES = (("max_candidates", (32, 64, 128, 256)), ("scene_tile", (32, 64, 128)),
                ("model_tile", (128, 256, 512)))
GRID_CELLS = {"p2p": (65536, 131072, 262144, 1_000_000), "plane": (131072, 1_000_000),
              "knn": (131072, 262144, 1_000_000)}
# Agreement with the run at JAX's sizes: K4's first-iteration indices and
# K7's neighbours bit-equal (exact folds, lowest-index ties, whatever the
# tiling); point-to-point converged runs the same iterations and points
# within GRID_P2P_ATOL; the plane engine's GRID_PLANE_ITERS fixed
# iterations within GRID_PLANE_ATOL (the kd order of the scene changes with
# the tile, so the float32 Gauss-Newton sums add in another order; PR 17's
# bound between two paths' points, DISPATCH_POINTS_ATOL)
GRID_P2P_ATOL = 1e-6
GRID_PLANE_ATOL = 1e-5
GRID_PLANE_ITERS = 10


def resolved(kind: str, setting: dict, device: str) -> dict:
    """``setting`` with each None replaced by the package's own size on
    ``device`` (what a caller who gives none gets)."""
    import torch

    from icp_tpu_torch.config import grid_sizes
    from icp_tpu_torch.engine.grid import bound_stride_for

    keys = ("scene_tile", "model_tile", "max_candidates")
    base = grid_sizes(device, knn=kind == "knn")
    out = {k: b if setting.get(k) is None else setting[k] for k, b in zip(keys, base)}
    if kind == "p2p":
        out["bound_stride"] = bound_stride_for(torch.device(device)) \
            if setting.get("bound_stride") is None else setting["bound_stride"]
    return out


class GridCell:
    """One cell of the grid section: point-to-point (``_icp_grid`` in fixed
    mode, as ``icp_fixed_iters`` calls it, ``qcp_fused``), point-to-plane
    (``icp_point_to_plane``, the model's normals given) or the normals'
    kNN (``knn_indices(k=17, method="grid")``) at ``n`` rows; a setting's
    None sizes are left to the package."""

    def __init__(self, kind: str, n: int, device: str):
        self.kind, self.n, self.device = kind, n, device
        self.model, self.scene = pair(n, device)
        self.normals = None
        if kind == "plane":
            from icp_tpu_torch.ops.normals import estimate_normals

            self.normals = estimate_normals(self.model, k=16)
        self.iters = iters_for(n)

    def run(self, s: dict, k: int = 1, converge: bool = False):
        given = {k_: v for k_, v in s.items() if v is not None}
        if self.kind == "knn":
            from icp_tpu_torch.ops.normals import knn_indices

            return knn_indices(self.model, cs.NORMAL_K, method="grid",
                               **{f"grid_{k_}": v for k_, v in given.items()})
        if self.kind == "plane":
            from icp_tpu_torch import ICPConfig
            from icp_tpu_torch.engine.point_to_plane import icp_point_to_plane

            cfg = ICPConfig(max_iter=k, threshold=-math.inf, nn_method="grid",
                            **{f"grid_{k_}": v for k_, v in given.items()})
            return icp_point_to_plane(self.model, self.scene, cfg, normals=self.normals)
        from icp_tpu_torch.engine.grid import _icp_grid

        names = {"scene_tile": "scene_tile_target", "model_tile": "model_tile_target",
                 "max_candidates": "max_candidates", "bound_stride": "bound_stride"}
        return _icp_grid(self.model, self.scene, threshold=1e-5 if converge else -math.inf,
                         bound=k, length=k, solver="qcp_fused", with_scale=True,
                         reference_compat=True, converge=converge,
                         **{names[k_]: v for k_, v in given.items()})

    def timer(self, s: dict):
        """(seconds an iteration or a call, seconds of set-up + first
        iteration; 0 for the kNN)."""
        from icp_tpu_torch.bench.harness import differenced, wall_time

        if self.kind == "knn":
            return wall_time(lambda: self.run(s), reps=REPS), 0.0
        return differenced(lambda k: float(self.run(s, k).err), *self.iters, REPS)

    def answers(self, s: dict) -> dict:
        """The tables of a short run (K4: the first and third iteration's;
        K7: the seed's and the exact pass's), its peak memory, and what
        the agreement compares."""
        import torch

        from icp_tpu_torch.engine.grid import _prepare_scene

        on_card = self.device == "cuda"
        rec = []
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        with cs.recorded_tables(rec):
            out = self.run(s, 3)
            if self.kind != "knn":
                float(out.err)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None
        got = {"peak_gib": None if peak is None else round(peak, 4)}
        if self.kind == "knn":
            got["tables"] = [dict(r, launch=lbl) for r, lbl in zip(rec, ("seed", "exact"))]
            got["idx"] = out
            return got
        k4 = [r for r in rec if r["kernel"] == "K4"]
        got["tables"] = [dict({k_: v for k_, v in r.items() if k_ != "idx"}, iteration=i + 1)
                         for i, r in enumerate(k4) if i in (0, 2)]
        tile = resolved(self.kind, s, self.device)["scene_tile"]
        inv = _prepare_scene(self.scene, tile)[2]
        got["first_idx"] = k4[0]["idx"][inv]
        if self.kind == "p2p":
            got["final"] = self.run(s, 30, converge=True)
        else:
            got["final"] = self.run(s, GRID_PLANE_ITERS)
        return got

    def agree(self, got: dict, ref: dict) -> dict:
        """``got`` against the answers at JAX's sizes, and whether it holds."""
        import torch

        if self.kind == "knn":
            same = bool(torch.equal(got["idx"], ref["idx"]))
            return {"idx_equal_jax_sizes": same, "held": same}
        same = bool(torch.equal(got["first_idx"], ref["first_idx"]))
        a, b = got["final"], ref["final"]
        off = gap(a.points, b.points)
        iters, iters_ref = int(a.iters), int(b.iters)
        tol = GRID_P2P_ATOL if self.kind == "p2p" else GRID_PLANE_ATOL
        return {"first_idx_equal_jax_sizes": same, "iters": iters, "iters_jax_sizes": iters_ref,
                "err": float(a.err), "err_jax_sizes": float(b.err), "max_point_gap": off,
                "atol": tol, "held": same and iters == iters_ref and off <= tol}


def grid_label(s: dict) -> str:
    return ",".join(f"{k}={'auto' if v is None else v}" for k, v in s.items())


def measure(out: Out, cell: GridCell, stage: str, settings: dict, ref: dict) -> dict:
    """Each setting of ``settings`` (label -> sizes) on ``cell``: its tables,
    peak memory and agreement with ``ref`` (the answers at JAX's sizes),
    then ``PASSES`` passes of every setting's timer, interleaved.  Prints a
    ``grid`` line a setting; returns label -> (times, set-up times, held)."""
    agreed = {}
    for label, s in settings.items():
        got = cell.answers(s)
        agreed[label] = (got, cell.agree(got, ref))
    t = timed_passes({label: (lambda s=s: cell.timer(s)) for label, s in settings.items()})
    res = {}
    for label, s in settings.items():
        got, agreement = agreed[label]
        times = summarize(t[label][0])
        first = None if cell.kind == "knn" else summarize(t[label][1])
        out(section="grid", kind=cell.kind, n=cell.n, stage=stage, setting=label,
            sizes=resolved(cell.kind, s, cell.device),
            iter_counts=None if cell.kind == "knn" else cell.iters, **times,
            setup_plus_first_ms=None if first is None else first["ms"],
            setup_plus_first_spread_ms=None if first is None else first["spread_ms"],
            peak_gib=got["peak_gib"], tables=got["tables"], **agreement)
        res[label] = (times, first, agreement["held"])
    return res


def search_axis(out: Out, cell: GridCell, base: dict, axis: str, values, ref: dict) -> dict:
    """One coordinate of the search at ``base``: the setting of each value,
    the best held one by ms an iteration (by set-up + first iteration for
    the seed stride, which changes only the first table), and its verdicts
    against the base's value and the value of JAX's sizes.  Returns the
    new base: the best where it beats the base's value by more than the
    spread of their passes, else the base."""
    settings = {f"{axis}={v}": dict(base, **{axis: v}) for v in values}
    res = measure(out, cell, f"axis:{axis}", settings, ref)
    key = 1 if axis == "bound_stride" else 0
    held = {lbl: r[key] for lbl, r in res.items() if r[2]}
    here = f"{axis}={base[axis]}"
    jax_label = f"{axis}={(JAX_NORMALS if cell.kind == 'knn' else JAX_GRID)[axis]}"
    best = min(held, key=lambda lbl: held[lbl]["ms"]) if held else here
    v_base = verdict(held, here, best) if here in held else None
    v_jax = verdict(held, jax_label, best) if jax_label in held else None
    moved = best != here and (v_base is None or v_base["beyond_spread"])
    out(section="grid_axis", kind=cell.kind, n=cell.n, axis=axis, base=grid_label(base),
        metric="setup_plus_first_ms" if key else "ms", best=best, held=sorted(held),
        best_vs_base=v_base, best_vs_jax=v_jax, moved=moved)
    return settings[best] if moved else base


def section_grid(out: Out, device: str, cells: dict) -> dict:
    """The grid section: for each cell kind and size, the coordinate search
    from JAX's sizes, then (``confirm``) at every size JAX's sizes against
    the package's own on this device and the search's best at the kind's
    largest size.  Returns kind -> n -> the search's best sizes."""
    best = {}
    for kind, sizes in cells.items():
        jax = dict(JAX_NORMALS if kind == "knn" else JAX_GRID)
        axes = NORMALS_AXES if kind == "knn" else GRID_AXES
        if kind == "plane":
            jax.pop("bound_stride")
            axes = tuple(a for a in axes if a[0] != "bound_stride")
        best[kind] = {}
        for n in sizes:
            cell = GridCell(kind, n, device)
            ref = cell.answers(jax)
            base = dict(jax)
            for axis, values in axes:
                base = search_axis(out, cell, base, axis, values, ref)
            best[kind][n] = base
            out(section="grid_best", kind=kind, n=n, sizes=base, jax_sizes=jax)
            del cell, ref
        top = best[kind][max(sizes)]
        for n in sizes:
            cell = GridCell(kind, n, device)
            ref = cell.answers(jax)
            sides = {"jax": jax}
            own = {k: None for k in jax}
            if resolved(kind, own, device) != jax:
                sides["package"] = own
            if top != jax and resolved(kind, own, device) != top:
                sides["search_best"] = top
            res = measure(out, cell, "confirm", sides, ref)
            times = {lbl: r[0] for lbl, r in res.items()}
            firsts = {lbl: r[1] for lbl, r in res.items() if r[1] is not None}
            out(section="grid_confirm", kind=kind, n=n,
                sides={lbl: resolved(kind, s, device) for lbl, s in sides.items()},
                held={lbl: r[2] for lbl, r in res.items()},
                ms_vs_jax={lbl: verdict(times, "jax", lbl) for lbl in sides if lbl != "jax"},
                setup_plus_first_vs_jax={lbl: verdict(firsts, "jax", lbl) for lbl in firsts
                                         if lbl != "jax"})
            del cell, ref
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sections", default="p2p,plane,normals,chain")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "dispatch_sweep.jsonl"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--sizes", default=None, help="comma list (default: SIZES; the CPU's "
                                                  "rehearsal gives its own)")
    ap.add_argument("--normal-sizes", default=None)
    ap.add_argument("--bunny-subsample", type=int, default=1)
    ap.add_argument("--grid-rows", default=None, help="comma list: the grid section's rows "
                                                      "for every kind (default: GRID_CELLS)")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("dispatch_sweep: no CUDA device (pass --device cpu to rehearse)", file=sys.stderr)
        return 1
    sizes = tuple(int(s) for s in args.sizes.split(",")) if args.sizes else SIZES
    nsizes = tuple(int(s) for s in args.normal_sizes.split(",")) if args.normal_sizes \
        else NORMAL_SIZES
    sections = set(args.sections.split(","))
    if args.device == "cuda":
        cs.phase_build()
    out = Out(args.out, args.device)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(io.StringIO()) if args.device == "cpu" \
                else contextlib.nullcontext():
            summary = {}
            if "p2p" in sections:
                rows = section_p2p(out, sizes, args.device)
                summary["p2p_grid_faster_than_pipeline_from"] = crossover(
                    [(n, v["pipeline_vs_grid"]) for n, v in rows], "pipeline", "grid")
                summary["p2p_grid_faster_than_fused_from"] = crossover(
                    [(n, v["fused_vs_grid"]) for n, v in rows], "fused", "grid")
                summary["p2p_pipeline_faster_than_fused_from"] = crossover(
                    [(n, v["pipeline_vs_fused"]) for n, v in rows], "fused", "pipeline")
            if "plane" in sections:
                summary["plane_grid_faster_than_dense_from"] = crossover(
                    section_plane(out, sizes, args.device), "dense", "grid")
            if "normals" in sections:
                summary["normals_grid_faster_than_dense_from"] = crossover(
                    section_normals(out, nsizes, args.device), "dense", "grid")
            if "chain" in sections:
                section_chain(out, args.device, args.bunny_subsample)
            if "grid" in sections:
                cells = GRID_CELLS if not args.grid_rows else {
                    kind: tuple(int(r) for r in args.grid_rows.split(",")) for kind in GRID_CELLS}
                summary["grid_best"] = {kind: {str(n): v for n, v in b.items()}
                                        for kind, b in section_grid(out, args.device, cells).items()}
            out(section="summary", seconds=round(time.perf_counter() - t0, 1), **summary)
    finally:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
