#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``icp_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--phases kernels,cli,scale]

Phases, in order; any failure ends the run with a non-zero exit:

  1. device: the card, and ``nvidia-smi``'s name and power limit;
  2. build: ``nvcc`` builds every kernel from ``icp_tpu_torch/csrc``;
  3. kernels: K1-K4 at the shapes of the main path, each against its plain
     PyTorch version on the same inputs on the card (indices exactly equal,
     float64 sums and state blocks within the stated tolerances), with the
     median times of both (CUDA events);
  4. cli: the reference program's path, ``engine.cli.main`` with
     ``--device cuda``, on cow_tr1 10 and cow_tr2 10 (fused path) and
     horse_tr1 3 (grid path), each trace and ``output.txt`` held against
     the reference binary's fixtures, with the kernel launch counts of the
     runs; then ms/iter of the cow and horse loops;
  5. scale: a 1,000,000 x 1,000,000 pair (horse upsampled with seeded
     jitter, a known similarity), 10 fixed grid iterations; the first
     iteration's correspondences checked against K1 brute force on 65,536
     seeded scene rows.

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
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXDIR = os.path.join(ROOT, "tests", "fixtures", "reference")
_TRACE_RE = re.compile(r"\[ICP\] iteration number (\d+) \| error value = (\S+)")

KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "nn_dense": ("icp_tpu_torch/csrc/nn_dense.cu", "icp_tpu/kernels/nn_pallas.py:99"),
    "qcp_step": ("icp_tpu_torch/csrc/qcp.cu", "icp_tpu/kernels/qcp_pallas.py:122"),
    "icp_fused": ("icp_tpu_torch/csrc/icp_fused.cu", "icp_tpu/kernels/icp_fused.py:128"),
    "nn_grid": ("icp_tpu_torch/csrc/nn_grid.cu", "icp_tpu/kernels/nn_grid.py:240"),
}
# (fixture, model file, scene file, nb_iter, iterations, output atol)
CLI_CASES = [
    ("cow_tr1", "cow_ref.txt", "cow_tr1.txt", 10, 7, 1e-5),
    ("cow_tr2", "cow_ref.txt", "cow_tr2.txt", 10, 10, 1e-5),
    ("horse_tr1", "horse_ref.txt", "horse_tr1.txt", 3, 3, 2e-6),
]
TRACE_RTOL = 1e-2  # on entries > 1e-6: float32 coordinates, see ROADMAP C6


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


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


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
    regs = re.findall(r"Function properties for (\S+)|Used (\d+) registers",
                      _build.build_info.get("ptxas", ""))
    if regs:
        print("[build] ptxas: " + " ".join(a or b for a, b in regs), flush=True)


def _load(name):
    from icp_tpu_torch.io.csv import load_matrix

    with contextlib.redirect_stderr(io.StringIO()):
        return load_matrix(os.path.join(ROOT, "data", name))


def phase_kernels(seed: int, record: dict):
    import numpy as np
    import torch

    from icp_tpu_torch.engine.grid import _prepare_scene
    from icp_tpu_torch.kernels import icp_fused, nn_dense, nn_grid, qcp
    from icp_tpu_torch.ops.alignment import Similarity, compute_alignment_stats

    dev = torch.device("cuda")
    f32 = dict(dtype=torch.float32, device=dev)
    cow_ref = torch.tensor(_load("cow_ref.txt"), **f32)
    cow_tr1 = torch.tensor(_load("cow_tr1.txt"), **f32)
    horse_ref = torch.tensor(_load("horse_ref.txt"), **f32)
    horse_tr1 = torch.tensor(_load("horse_tr1.txt"), **f32)

    # K1: cow 2,903^2, and the grid path's bound seed (kd-padded horse scene
    # x every 16th model point).
    p0, _, _, tn, _ = _prepare_scene(horse_tr1, 256)
    sub = horse_ref[::16].contiguous()
    k1 = {}
    for label, s, m in (("cow", cow_tr1, cow_ref), ("horse_seed", p0.contiguous(), sub)):
        ik, dk = nn_dense.nn_dense(s, m, with_dist=True)
        ip, dp = nn_dense.nn_dense_plain(s, m, with_dist=True)
        require(torch.equal(ik, ip), f"K1 {label}: indices differ from plain")
        k1[label] = (max_abs(dk, dp), cuda_ms(lambda: nn_dense.nn_dense(s, m), 20),
                     cuda_ms(lambda: nn_dense.nn_dense_plain(s, m), 5))
        say("kernels", kernel="nn_dense", shape=f"{s.shape[0]}x{m.shape[0]}",
            idx_equal=True, d2_max_abs_err=k1[label][0],
            ms=f"{k1[label][1]:.4f}", plain_ms=f"{k1[label][2]:.4f}")
    record["nn_dense"] = (max(v[0] for v in k1.values()), *k1["horse_seed"][1:])

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
    k2_err = 0.0
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
        k2_err = max(k2_err, max_abs(sk, sp), max_abs(ek[:1], ep[:1]))
    require(k2_err <= 1e-9, f"K2: state differs from plain by {k2_err}")

    def k2_bench(fn):
        st, ctl, errs = prev.clone(), qcp.new_loop_control(1 << 20, dev), qcp.new_err_buffer(1 << 20, dev)
        return lambda: fn(parts, st, ctl, errs, threshold=-math.inf)

    record["qcp_step"] = (k2_err, cuda_ms(k2_bench(qcp.qcp_step), 50),
                          cuda_ms(k2_bench(qcp.qcp_step_plain), 10))
    say("kernels", kernel="qcp_step", rows="1,23", state_max_abs_err=k2_err,
        ms=f"{record['qcp_step'][1]:.4f}", plain_ms=f"{record['qcp_step'][2]:.4f}")

    # K3: cow, from the identity and from a non-identity state.
    prep = icp_fused.prepare_fused_inputs(cow_tr1, cow_ref)
    k3_err = 0.0
    for label, st0 in (("identity", qcp.identity_state(dev)), ("warm", prev)):
        ctl0 = qcp.new_loop_control(4, dev)
        pk = icp_fused.fused_partials(prep, st0, ctl0)
        pp = icp_fused.fused_partials_plain(prep, st0)
        sums_k = pk.sum(0)
        rel = float(((sums_k - pp[0]).abs() / pp[0].abs().clamp(min=1.0)).max())
        require(rel <= 1e-9, f"K3 {label}: sums differ from plain by {rel}")
        outs = []
        for partials_fn, step_fn in ((icp_fused.fused_partials, qcp.qcp_step),
                                     (lambda pr, st, _: icp_fused.fused_partials_plain(pr, st),
                                      qcp.qcp_step_plain)):
            st, ctl, errs = st0.clone(), qcp.new_loop_control(4, dev), qcp.new_err_buffer(4, dev)
            step_fn(partials_fn(prep, st, ctl), st, ctl, errs, threshold=1e-5, err_factor=2.0)
            outs.append((st, errs))
        err = max(max_abs(outs[0][0], outs[1][0]), max_abs(outs[0][1][:1], outs[1][1][:1]))
        require(err <= 1e-8, f"K3 {label}: state differs from plain by {err}")
        k3_err = max(k3_err, err, rel)
        say("kernels", kernel="icp_fused", start=label, rows=pk.shape[0],
            sums_max_rel_err=rel, state_max_abs_err=err)
    bench_ctl = qcp.new_loop_control(4, dev)
    st_b = qcp.identity_state(dev)
    record["icp_fused"] = (k3_err,
                           cuda_ms(lambda: icp_fused.fused_partials(prep, st_b, bench_ctl), 50),
                           cuda_ms(lambda: icp_fused.fused_partials_plain(prep, st_b), 10))
    say("kernels", kernel="icp_fused", shape="2903x2903",
        ms=f"{record['icp_fused'][1]:.4f}", plain_ms=f"{record['icp_fused'][2]:.4f}")

    # K4: horse, the first iteration's real candidate table, and the
    # forced-overflow table (max_candidates=1: every tile folds all tiles).
    grid = nn_grid.build_model_grid(horse_ref, target_tile=1024)
    u0 = nn_grid.bound_from_indices(p0, grid, nn_grid.initial_bound_indices(p0, horse_ref))
    idx_bf = nn_dense.nn_dense(p0.contiguous(), horse_ref)
    k4_err, k4_times = 0.0, None
    for cap in (16, 1):
        cand, counts, over = nn_grid.candidates(p0, u0, grid, scene_tile=tn, cap=cap)
        args = (cand, counts, p0.contiguous(), grid.tiles, tn)
        dk, ik, yk = nn_grid.nn_grid(*args)
        dp, ip, yp = nn_grid.nn_grid_plain(*args)
        require(torch.equal(ik, ip), f"K4 cap={cap}: indices differ from plain")
        require(torch.equal(ik, idx_bf), f"K4 cap={cap}: indices differ from brute force")
        err = max(max_abs(dk, dp), max_abs(yk, yp))
        require(err == 0.0, f"K4 cap={cap}: d2/y differ from plain by {err}")
        k4_err = max(k4_err, err)
        times = (cuda_ms(lambda: nn_grid.nn_grid(*args), 20),
                 cuda_ms(lambda: nn_grid.nn_grid_plain(*args), 3))
        k4_times = k4_times or times
        say("kernels", kernel="nn_grid", max_candidates=cap, tiles=f"{cand.shape[0]}x{grid.tiles.shape[0]}",
            mean_count=f"{counts.double().mean().item():.2f}", overflow=bool(over),
            idx_equal=True, max_abs_err=err, ms=f"{times[0]:.4f}", plain_ms=f"{times[1]:.4f}")
    record["nn_grid"] = (k4_err, *k4_times)


def _golden(name):
    with open(os.path.join(FIXDIR, f"{name}_stderr.txt")) as f:
        return [float(e) for _, e in _TRACE_RE.findall(f.read())]


def phase_cli(tmp: str) -> dict:
    import numpy as np
    import torch

    from icp_tpu_torch.engine.cli import main as cli_main
    from icp_tpu_torch.io.csv import load_matrix
    from icp_tpu_torch.kernels import _build

    _build.reset_counts()
    for fixture, ref, scene, nb_iter, want_iters, atol in CLI_CASES:
        before = dict(_build.LAUNCHES)
        out_path = os.path.join(tmp, f"{fixture}_output.txt")
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli_main([os.path.join(ROOT, "data", ref), os.path.join(ROOT, "data", scene),
                           str(nb_iter), "--device", "cuda", "--output", out_path])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        require(rc == 0, f"cli {fixture}: exit {rc}\n{err.getvalue()}")
        got = [float(e) for _, e in _TRACE_RE.findall(err.getvalue())]
        want = _golden(fixture)
        require(len(got) == want_iters == len(want),
                f"cli {fixture}: {len(got)} iterations, reference {len(want)}")
        big = [(g, w) for g, w in zip(got, want) if w > 1e-6]
        worst = max(abs(g - w) / w for g, w in big)
        require(worst <= TRACE_RTOL, f"cli {fixture}: trace off by {worst:.3g} relative")
        with contextlib.redirect_stderr(io.StringIO()):
            out = load_matrix(out_path)
            gold = load_matrix(os.path.join(FIXDIR, f"{fixture}_output.txt"))
        require(out.shape == gold.shape and bool(np.isfinite(out).all()),
                f"cli {fixture}: output shape {out.shape}")
        off = float(np.abs(out - gold).max())
        # np.testing.assert_allclose's rule (rtol 1e-7): both clouds are
        # printed at 6 significant digits, a last-digit step above 1 is 1e-5
        require(bool(np.all(np.abs(out - gold) <= atol + 1e-7 * np.abs(gold))),
                f"cli {fixture}: output {off:.3g} from the reference")
        used = {k: _build.LAUNCHES[k] - before[k] for k in before}
        if fixture.startswith("cow"):
            require(used["icp_fused"] >= want_iters and used["qcp_step"] >= want_iters,
                    f"cli {fixture}: fused path not taken ({used})")
        else:
            require(used["nn_grid"] >= want_iters and used["qcp_step"] >= want_iters
                    and used["nn_dense"] >= 1, f"cli {fixture}: grid path not taken ({used})")
        say("cli", case=fixture, iters=len(got), trace_max_rel_err=f"{worst:.3e}",
            output_max_abs_err=f"{off:.3e}", seconds=f"{seconds:.3f}", launches=used)
    return dict(_build.LAUNCHES)


def phase_loop_times():
    import torch

    from icp_tpu_torch.engine.icp import icp_fixed_iters

    for label, ref, scene, nn in (("cow", "cow_ref.txt", "cow_tr1.txt", "pallas"),
                                  ("horse", "horse_ref.txt", "horse_tr1.txt", "grid")):
        model = torch.tensor(_load(ref), dtype=torch.float32, device="cuda")
        sc = torch.tensor(_load(scene), dtype=torch.float32, device="cuda")

        def run(k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = icp_fixed_iters(model, sc, n_iters=k, solver="qcp_fused", nn_method=nn)
            float(res.err)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        run(2)
        t1 = statistics.median(run(1) for _ in range(3))
        t21 = statistics.median(run(21) for _ in range(3))
        say("loop", case=label, path=nn, ms_per_iter=f"{(t21 - t1) / 20 * 1e3:.4f}",
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


def phase_scale(seed: int):
    import numpy as np
    import torch

    from icp_tpu_torch.engine.grid import _prepare_scene
    from icp_tpu_torch.engine.icp import icp_fixed_iters
    from icp_tpu_torch.kernels import nn_dense, nn_grid

    n = 1_000_000
    model, scene, s_true = scale_pair(seed, n)
    rng = np.random.default_rng(seed + 1)

    # First iteration's correspondences against K1 brute force.
    grid = nn_grid.build_model_grid(model, target_tile=1024)
    p0, _, _, tn, _ = _prepare_scene(scene, 256)
    u0 = nn_grid.bound_from_indices(p0, grid, nn_grid.initial_bound_indices(p0, model))
    idx, _, d2, over = nn_grid.closest_point_indices_pruned(p0, grid, u0, scene_tile=tn)
    rows = torch.tensor(np.sort(rng.choice(p0.shape[0], 65536, replace=False)), device="cuda")
    idx_bf, d2_bf = nn_dense.nn_dense(p0[rows].contiguous(), model, with_dist=True)
    mism = int((idx[rows] != idx_bf).sum())
    require(mism == 0, f"scale: {mism} of 65536 first-iteration matches differ from brute force")
    require(bool(torch.equal(d2[rows], d2_bf)), "scale: first-iteration distances differ")

    def run(k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = icp_fixed_iters(model, scene, n_iters=k, solver="qcp_fused", nn_method="grid")
        err = float(res.err)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, res, err

    run(1)
    t1, _, err1 = run(1)
    t10, res, err10 = run(10)
    pts = res.points
    require(pts.shape == (n, 3) and bool(torch.isfinite(pts).all()), "scale: bad output cloud")
    require(math.isfinite(err10) and err10 < err1, f"scale: error {err1} -> {err10}")
    say("scale", points=f"{n}x{n}", first_iter_checked=65536, first_iter_overflow=bool(over),
        err_iter1=f"{err1:.6e}", err_iter10=f"{err10:.6e}",
        s=f"{float(res.transform.s):.6f}", s_inverse_true=f"{1 / s_true:.6f}",
        ms_per_iter=f"{(t10 - t1) / 9 * 1e3:.3f}", ten_iters_s=f"{t10:.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="kernels,cli,scale",
                    help="comma list of kernels, cli, scale (device and build always run)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import icp_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = phase_device()
    phase_build()
    record = {}
    if "kernels" in phases:
        phase_kernels(args.seed, record)
    launches = {}
    if "cli" in phases:
        out_dir = os.path.join(ROOT, "chiprun_out", "chip_smoke")
        os.makedirs(out_dir, exist_ok=True)
        launches = phase_cli(out_dir)
        phase_loop_times()
    if "scale" in phases:
        phase_scale(args.seed)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        err, ms, plain_ms = record.get(name, (None, None, None))
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches.get(name),
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
