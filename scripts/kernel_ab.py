#!/usr/bin/env python3
"""Time K1 (dense NN), K2 (alignment step), K3 (fused dense iteration), K4
(kd-tile NN), K5 (rotation solve), K6 (dense kNN), K7 (kd-tile kNN), K8
(lane-chunked NN), K9 (bf16-prefilter NN) and K10 (K1's "mxu" form) of one
checkout on one CUDA card.

    python3 scripts/kernel_ab.py [--root DIR] [--label NAME] [--sections LIST]

``--root`` names the checkout whose ``icp_tpu_torch`` is measured (default:
this one), so two versions can be timed in one call on one card, in turns
(parent, change, change, parent).  The tables and clouds come from this
checkout's ``chip_smoke.py`` and ``data/``:

  * K1 at cow (2,903^2), on horse's grid seed (49,152 x 3,031) and on the
    1M pair's seed (1,015,808 x 62,500), and K10 beside it at cow and the
    grid seed where the checkout has it;
  * K9 at cow (2,903^2), horse (48,485^2) and the jittered 4^3 lattice
    (8,192 x 64) of ``chip_smoke.py``, centred as its entry point centres,
    each also by its device microseconds a call (prep and fold);
  * K4 on horse's first-iteration candidate table (capacity 16 and 1, and
    with the 3-wide normals payload), and on the 1,000,000-point pair's
    first- and third-iteration tables;
  * K6 at cow (2,903^2) and horse (48,485^2) with k 17, cow with k 32, and
    a lattice of equal distances (4,096 x 8,192, k 17);
  * K7's seed and exact launches of the horse and the 1M model's normals
    (k 17), each as that checkout's ``knn_grid`` makes it (with the seed
    bound where its ``knn_worklist`` takes one), and the 1M ``knn_indices``
    wall time;
  * the point-to-point grid loop's ms/iter and set-up + first iteration
    at horse and at 1M;
  * one dense fused iteration at cow (``fused_icp_step``: one K3 launch
    that solves in its last block, or K3 then K2 in a checkout from before
    that), from the identity and from a warm state; K2 alone with 1 and 23
    rows; the cow point-to-point loop (fused path): ms/iter over 200
    iterations and the device's busy share of a profiled 200-iteration
    run; and horse's point-to-point loop (grid path, K2 each iteration);
  * K8 beside K1 at cow, the grid seed and the 1M seed, each with its
    device microseconds a call; K5 on the cow statistics through its
    packed entry, the packed solve as the parent's ``qcp_fused`` step makes
    it (pack, launch, slice, cast) and ``qcp_rotation_from`` where the
    checkout has it, each also by the host's microseconds a call; the cow
    point-to-point loop with ``--nn bcast --solver qcp_fused`` (K5 each
    iteration): ms/iter over 200 iterations and its device launches an
    iteration.

Kernel times are medians of CUDA events, after a second of matrix products
that brings the card from its idle clock (~345 MHz) to its working one;
loop times are host clocks around
runs that end in ``torch.cuda.synchronize()``, the difference of two
iteration counts; device microseconds come from ``torch.profiler`` (the
mean of a kernel's launches; for the fused iteration, K3's and K2's
kernels summed, each launch from its start state).  ``--sections`` picks
``dense`` (K1, K10, K9), ``grid`` (K4, K6, K7, the loops and the 1M pair;
the longest part), ``knn`` (K6 and K7 at horse's and cow's k 17 and 32
and the lattice, grid's kNN lines alone), ``fused`` (K3, K2, the cow
loop), ``chunked_rotation`` (K8, K5, the cow bcast loop) and ``batched``
(``icp_batched`` with bf16 at B = 8 and 32: ms a pair, K9's launches);
default dense and grid.  Prints one JSON line, with the card's name and power limit, and
exits 1 without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop_ms(cs, model, scene, k, nn):
    """(ms/iter, set-up + first iteration ms) of the point-to-point loop
    on path ``nn``: medians of fixed-iteration runs of 1 and k + 1
    iterations."""
    from icp_tpu_torch.engine.icp import icp_fixed_iters

    def run(i):
        return cs._wall(lambda: float(icp_fixed_iters(model, scene, n_iters=i,
                                                      solver="qcp_fused", nn_method=nn).err))
    run(2)
    t1 = statistics.median(run(1) for _ in range(5))
    tk = statistics.median(run(k + 1) for _ in range(5))
    return (tk - t1) / k * 1e3, t1 * 1e3


def host_us(fn, reps: int) -> float:
    """Mean host microseconds a call of ``fn`` over ``reps`` calls, with no
    synchronisation between them: the wrapper's own cost."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def fused_section(cs, cow_ref, cow_tr1, horse_ref, horse_tr1) -> dict:
    """K3 + K2 at cow, K2 alone with 1 and 23 rows, the cow loop (ms/iter
    over 200 iterations, and the busy share of a profiled 200-iteration
    run) and the horse loop (K2 on the grid path)."""
    import math

    import numpy as np
    import torch

    from icp_tpu_torch.engine.icp import icp_fixed_iters
    from icp_tpu_torch.kernels import icp_fused, qcp
    from icp_tpu_torch.ops.alignment import Similarity, compute_alignment_stats

    spec = importlib.util.spec_from_file_location(
        "profile_torch", os.path.join(HERE, "scripts", "profile_torch.py"))
    prof_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof_mod)
    dev = cow_ref.device
    out = {}
    rng = np.random.default_rng(0)
    a = 0.3
    warm = qcp.pack_total_state(Similarity(
        torch.tensor(1.04), torch.tensor([[math.cos(a), -math.sin(a), 0.0],
                                          [math.sin(a), math.cos(a), 0.0], [0.0, 0.0, 1.0]]),
        torch.tensor([0.05, -0.1, 0.02])), dev)
    prep = icp_fused.prepare_fused_inputs(cow_tr1, cow_ref)
    names = ("icp_fused_kernel", "qcp_step_kernel")
    for label, st0 in (("identity", qcp.identity_state(dev)), ("warm", warm)):
        st, ctl, errs = (st0.clone(), qcp.new_loop_control(1 << 20, dev),
                         qcp.new_err_buffer(1 << 20, dev))

        def step():
            icp_fused.fused_icp_step(prep, st, ctl, errs, threshold=-math.inf)

        out[f"k3_cow_{label}_ms"] = cs.cuda_ms(step, 50)

        def step_from_start():
            st.copy_(st0)
            step()

        out[f"k3_cow_{label}_device_us"] = cs.device_us(step_from_start, names)
    pts = rng.standard_normal((1000, 3))
    P = torch.tensor(pts, dtype=torch.float64, device=dev)
    Y = torch.tensor(1.3 * pts + 0.2 + 1e-3 * rng.standard_normal((1000, 3)),
                     dtype=torch.float64, device=dev)
    for rows in (1, 23):
        parts = torch.cat([qcp.pack_stats(compute_alignment_stats(p, y))
                           for p, y in zip(P.chunk(rows), Y.chunk(rows))]).contiguous()
        st, ctl, errs = (warm.clone(), qcp.new_loop_control(1 << 20, dev),
                         qcp.new_err_buffer(1 << 20, dev))

        def k2(parts=parts, st=st, ctl=ctl, errs=errs):
            qcp.qcp_step(parts, st, ctl, errs, threshold=-math.inf)

        out[f"k2_rows{rows}_ms"] = cs.cuda_ms(k2, 50)
        out[f"k2_rows{rows}_device_us"] = cs.device_us(k2, ("qcp_step_kernel",))

    out["cow_p2p_ms_per_iter"], _ = loop_ms(cs, cow_ref, cow_tr1, 200, "pallas")
    out["horse_p2p_ms_per_iter"], _ = loop_ms(cs, horse_ref, horse_tr1, 20, "grid")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run(i):
        return float(icp_fixed_iters(cow_ref, cow_tr1, n_iters=i, solver="qcp_fused",
                                     nn_method="pallas").err)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = cs._wall(lambda: run(200))
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out["cow_p2p_busy_share"] = prof_mod._busy_share(kernels, wall * 1e6)
    return out


def chunked_rotation_section(cs, cow_ref, cow_tr1, horse_ref, p0) -> dict:
    """K8 beside K1 at cow, the grid seed and the 1M seed (CUDA events and
    device microseconds a call); K5 through its packed entry and, where the
    checkout has it, ``qcp_rotation_from`` (the cow statistics, float32 as
    the bcast loop holds them); the cow point-to-point loop with ``--nn
    bcast --solver qcp_fused``: ms/iter over 200 iterations and device
    launches an iteration."""
    import torch

    from icp_tpu_torch.engine.grid import _prepare_scene
    from icp_tpu_torch.engine.icp import icp_fixed_iters
    from icp_tpu_torch.kernels import nn_dense, qcp
    from icp_tpu_torch.ops.alignment import compute_alignment_stats

    out = {}
    k1_names, k8_names = ("nn_dense_fold_kernel", "nn_dense_epilogue_kernel"), ("nn_chunked",)
    model, scene, _ = cs.scale_pair(0)
    shapes = (("cow", cow_tr1, cow_ref, 50), ("grid_seed", p0, horse_ref[::16].contiguous(), 50),
              ("1M_seed", _prepare_scene(scene, 256)[0].contiguous(), model[::16].contiguous(), 5))
    del model, scene
    for label, s, m, reps in shapes:
        for name, fn, names in (("k8", lambda: nn_dense.nn_chunked(s, m), k8_names),
                                ("k1", lambda: nn_dense.nn_dense(s, m), k1_names)):
            out[f"{name}_{label}_ms"] = cs.cuda_ms(fn, reps)
            out[f"{name}_{label}_device_us"] = cs.device_us(fn, names, min(reps, 20))
    del shapes, s, m

    stats = compute_alignment_stats(cow_tr1, cow_ref[nn_dense.nn_dense(cow_tr1, cow_ref).long()])
    mu_p, mu_y = stats.sum_p / stats.n, stats.sum_y / stats.n
    S = stats.sum_py - stats.n * torch.outer(mu_p, mu_y)
    gp = stats.sum_pp - stats.n * torch.dot(mu_p, mu_p)
    gy = stats.sum_yy - stats.n * torch.dot(mu_y, mu_y)
    packed = qcp.pack_rotation_input(S, gp, gy)
    entries = {"packed": lambda: qcp.qcp_rotation(packed),
               "packed_solve": lambda: qcp.qcp_rotation(qcp.pack_rotation_input(
                   S, gp, gy))[0, :9].reshape(3, 3).to(S.dtype)}
    if hasattr(qcp, "qcp_rotation_from"):
        entries["from"] = lambda: qcp.qcp_rotation_from(S, gp, gy)
    for label, fn in entries.items():
        out[f"k5_{label}_ms"] = cs.cuda_ms(fn, 200)
        out[f"k5_{label}_device_us"] = cs.device_us(fn, ("qcp_rotation",), 50)
        out[f"k5_{label}_host_us"] = host_us(fn, 500)

    def run(i):
        return float(icp_fixed_iters(cow_ref, cow_tr1, n_iters=i, solver="qcp_fused",
                                     nn_method="bcast").err)

    out["cow_bcast_qcp_fused_ms_per_iter"], _ = loop_ms(cs, cow_ref, cow_tr1, 200, "bcast")
    out["cow_bcast_qcp_fused_launches_per_iter"] = cs.launches_per_iter(run)
    return out


def batched_section(cs) -> dict:
    """``icp_batched`` with ``nn_method="bf16"`` on the cow pairs of
    ``chip_smoke.py`` (B = 8 and 32, 10 iterations, ``eigh`` and
    ``qcp_fused``): ms a pair (the median of three host-clock runs) and K9's
    launches a run (a checkout from before K9's pair axis launches it once
    a pair an iteration)."""
    from icp_tpu_torch.engine.batched import icp_batched

    out = {}
    for b in (8, 32):
        models, scenes = cs._cow_pairs(0, b)
        for solver in ("eigh", "qcp_fused"):
            def run(models=models, scenes=scenes, solver=solver):
                return icp_batched(models, scenes, n_iters=10, solver=solver, nn_method="bf16")
            _, used = cs._counted(run)
            out[f"bf16_{solver}_B{b}_ms_per_pair"] = statistics.median(
                cs._wall(run) for _ in range(3)) * 1e3 / b
            out[f"bf16_{solver}_B{b}_k9_launches"] = used["nn_bf16"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="")
    ap.add_argument("--sections", default="dense,grid")
    args = ap.parse_args(argv)
    sections = set(args.sections.split(","))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    cs = _smoke()
    from icp_tpu_torch.engine.grid import _prepare_scene
    from icp_tpu_torch.kernels import knn_dense, knn_grid, nn_bf16, nn_dense, nn_grid
    from icp_tpu_torch.ops.normals import estimate_normals, knn_indices

    import icp_tpu_torch

    out = {"label": args.label, "package": os.path.dirname(icp_tpu_torch.__file__),
           "card": cs.phase_device()}
    f32 = dict(dtype=torch.float32, device="cuda")
    warm = torch.ones((4096, 4096), **f32)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        warm @ warm
    torch.cuda.synchronize()
    del warm

    takes_grid = "grid" in inspect.signature(nn_grid.nn_grid).parameters

    def k4_ms(grid, p, u, tn, cap, payload=False, reps=20):
        cand, counts, _ = nn_grid.candidates(p, u, grid, scene_tile=tn, cap=cap)
        kw = {"kd_row": grid.kd_row} if hasattr(grid, "kd_row") and not takes_grid else {}
        a = (cand, counts, p, grid if takes_grid else grid.tiles, tn,
             grid.payload if payload else None)
        return {"ms": cs.cuda_ms(lambda: nn_grid.nn_grid(*a, **kw), reps),
                "fallback_tiles": int((counts > cap).sum()),
                "mean_count": round(counts.double().mean().item(), 3)}

    bounded = "bound" in inspect.signature(knn_grid.knn_worklist).parameters

    def k7_ms(cloud, reps):
        """K7's seed and exact launches of ``cloud``'s normals, as this
        checkout's knn_grid makes them."""
        grid = nn_grid.build_model_grid(cloud, target_tile=256)
        q, _, _, tn, _ = _prepare_scene(cloud, 64)
        q = q.contiguous()
        bd2 = nn_grid.tile_box_dists(q, grid, scene_tile=tn)
        seed = knn_grid.seed_table(bd2, 17, grid.model_tile)
        d_seed, _ = knn_grid.knn_worklist(*seed, q, grid.tiles, tn, 17)
        kth = d_seed[:, 16].contiguous()
        cand, counts = knn_grid.cull_table(bd2, kth, tn, min(32, bd2.shape[1]))
        del bd2
        kw = {"bound": kth} if bounded else {}
        return {"seed_ms": cs.cuda_ms(lambda: knn_grid.knn_worklist(*seed, q, grid.tiles, tn, 17),
                                      reps),
                "exact_ms": cs.cuda_ms(lambda: knn_grid.knn_worklist(
                    cand, counts, q, grid.tiles, tn, 17, **kw), reps),
                "fallback_tiles": int((counts > cand.shape[1]).sum())}

    horse_ref = torch.tensor(cs._load("horse_ref.txt"), **f32)
    horse_tr1 = torch.tensor(cs._load("horse_tr1.txt"), **f32)
    cow_ref = torch.tensor(cs._load("cow_ref.txt"), **f32)
    cow_tr1 = torch.tensor(cs._load("cow_tr1.txt"), **f32)
    p0, _, _, tn, _ = _prepare_scene(horse_tr1, 256)
    p0 = p0.contiguous()
    sub = horse_ref[::16].contiguous()
    if "dense" in sections:
        mxu = "mxu" in getattr(nn_dense, "DISTANCE_IMPLS", ())
        for label, s, m in (("cow", cow_tr1, cow_ref), ("grid_seed", p0, sub)):
            out[f"k1_{label}_ms"] = cs.cuda_ms(lambda: nn_dense.nn_dense(s, m), 50)
            if mxu:
                out[f"k10_{label}_ms"] = cs.cuda_ms(
                    lambda: nn_dense.nn_dense(s, m, distance_impl="mxu"), 50)
        rng = np.random.default_rng(9)  # chip_smoke.py's lattice (its seed 0 + 9)
        sites = np.stack(np.meshgrid(*[np.arange(4.0)] * 3), -1).reshape(-1, 3)
        lat_m = torch.tensor(sites + 0.01 * rng.standard_normal(sites.shape), **f32)
        lat_s = torch.tensor(sites[rng.integers(0, len(sites), 8192)]
                             + 0.02 * rng.standard_normal((8192, 3)), **f32)
        for label, s, m, reps in (("cow", cow_tr1, cow_ref, 50), ("horse", horse_tr1, horse_ref, 20),
                                  ("lattice", lat_s, lat_m, 50)):
            c = m.mean(0)
            sc, mc = (s - c).contiguous(), (m - c).contiguous()
            out[f"k9_{label}_ms"] = cs.cuda_ms(lambda: nn_bf16.nn_bf16(sc, mc), reps)
            out[f"k9_{label}_device_us"] = cs.device_us(
                lambda: nn_bf16.nn_bf16(sc, mc), ("nn_bf16_prep_kernel", "nn_bf16_fold_kernel"),
                reps=10)
    if "fused" in sections:
        out.update(fused_section(cs, cow_ref, cow_tr1, horse_ref, horse_tr1))
    if "batched" in sections:
        out.update(batched_section(cs))
    if "chunked_rotation" in sections:
        out.update(chunked_rotation_section(cs, cow_ref, cow_tr1, horse_ref, p0))
    lat_q, lat_p = cs.tied_lattice(6)
    if "knn" in sections:
        out["k7_horse"] = k7_ms(horse_ref, 10)
        for label, q, pts, k, reps in (("cow", cow_ref, cow_ref, 17, 20),
                                       ("horse", horse_ref, horse_ref, 17, 5),
                                       ("cow_k32", cow_ref, cow_ref, 32, 20),
                                       ("lattice", lat_q, lat_p, 17, 20)):
            out[f"k6_{label}_ms"] = cs.cuda_ms(lambda: knn_dense.knn_dense(q, pts, k), reps)
            out[f"k6_{label}_device_us"] = cs.device_us(
                lambda: knn_dense.knn_dense(q, pts, k), ("knn_dense_kernel",), reps=10)
    if "grid" not in sections:
        print(json.dumps(out), flush=True)
        return 0
    out["k7_horse"] = k7_ms(horse_ref, 10)
    normals = estimate_normals(horse_ref, method="dense")
    grid = nn_grid.build_model_grid(horse_ref, target_tile=1024, payload=normals)
    u0 = nn_grid.bound_from_indices(p0, grid, nn_grid.initial_bound_indices(p0, horse_ref))
    out["k4_horse_cap16"] = k4_ms(grid, p0, u0, tn, 16)
    out["k4_horse_cap1"] = k4_ms(grid, p0, u0, tn, 1)
    out["k4_horse_payload"] = k4_ms(grid, p0, u0, tn, 16, payload=True)

    for label, q, pts, k, reps in (("cow", cow_ref, cow_ref, 17, 20),
                                   ("horse", horse_ref, horse_ref, 17, 5),
                                   ("cow_k32", cow_ref, cow_ref, 32, 20),
                                   ("lattice", lat_q, lat_p, 17, 20)):
        out[f"k6_{label}_ms"] = cs.cuda_ms(lambda: knn_dense.knn_dense(q, pts, k), reps)
    out["horse_p2p_ms_per_iter"], out["horse_p2p_first_iter_ms"] = loop_ms(
        cs, horse_ref, horse_tr1, 20, "grid")
    del grid, p0, u0, normals

    model, scene, _ = cs.scale_pair(0)
    mgrid, mtn, states = cs.grid_loop_states(model, scene, 3)
    for label, (p, u) in (("first", states[0]), ("third", states[2])):
        out[f"k4_1M_{label}"] = k4_ms(mgrid, p, u, mtn, 16, reps=10)
    p, sub = states[0][0], model[::16].contiguous()
    out["k1_1M_seed_ms"] = cs.cuda_ms(lambda: nn_dense.nn_dense(p, sub), 5)
    del mgrid, states, p, sub
    out["k7_1M"] = k7_ms(model, 5)
    knn_indices(model, 17, method="grid")
    out["1M_knn_indices_ms"] = statistics.median(
        cs._wall(lambda: knn_indices(model, 17, method="grid")) * 1e3 for _ in range(3))
    out["1M_p2p_ms_per_iter"], out["1M_p2p_first_iter_ms"] = loop_ms(cs, model, scene, 9, "grid")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
