#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port: ICP iterations/s on the
cow pair, on one card.

    python3 bench_torch.py [--device cuda|cpu]

Prints ONE JSON line on stdout:
  {"metric": "icp_iter_per_s_cow", "value": N, "unit": "iter/s", "vs_baseline": N, ...}

Baseline = the reference's best engine (GPU-opti on a GTX 1050): 20 ICP
iterations of the cow pair in 107 ms => ~187 iter/s (BASELINE.md).

Protocol: a convergence gate first (``icp`` on cow_ref / cow_tr1 with the
card's kernels must take 7 iterations and land on cow_ref), then the
fixed-iteration loop ``icp_fixed_iters`` timed at 20 and 520 iterations by
the host clock between two synchronisations, best of 8, differenced over
500 (``harness.loop_per_iter``): the fused path (K3 once an iteration), the
pipeline (K1, float64 sums, K2) and the grid path (K1 seed, K4, K2),
interleaved, three passes each.  ``value`` is the best pass of any path;
the record keeps the median, the spread and every pass, the iteration
counts, the card's name and power limit.  With ``--device cpu`` the plain
versions run (bcast / eigh, one path, best of 3), as the JAX benchmark
does off the TPU; the tests use it.

A failing kernel or path ends the run: the error JSON line, rc 1.  Nothing
falls back to another NN method, drops a path, or moves to the CPU.

The measurement runs in a child process (``bench_torch.py --measure``)
that marks its phases (spawn, init, gate, measure, done) on stderr; this
parent enforces a watchdog a phase and a total budget, kills the child's
process group on expiry, retries, and on final failure prints a
diagnostic JSON line (phase reached, elapsed, stderr tail per attempt)
instead of hanging its caller.

Env knobs (seconds unless noted):
  ICP_BENCH_INIT_TIMEOUT=600     init phase watchdog (the device's first
                                 answer, the data; imports and the CSV
                                 loader's build are in spawn)
  ICP_BENCH_GATE_TIMEOUT=1200    convergence gate (includes the kernels' build)
  ICP_BENCH_MEASURE_TIMEOUT=1500 timing phase
  ICP_BENCH_ATTEMPTS=2           supervised attempts
  ICP_BENCH_BACKOFF=20           sleep between attempts
  ICP_BENCH_TOTAL_TIMEOUT=2700   hard budget across all attempts
Test hooks: ICP_BENCH_TEST_HANG=<phase> hangs that phase,
ICP_BENCH_TEST_HANG_ONCE_FILE=<path> hangs the first init while the file
exists (and removes it), ICP_BENCH_TEST_DROP_VERDICT=1 exits 0 with no
JSON line (whatever the verdict), ICP_BENCH_TEST_ITERS=<small>,<big> times
the loops at those iteration counts instead of 20 and 520 (a short run,
refused with --device cuda: the headline is taken at 20 and 520 only; the
record carries the counts as ``iters_small`` / ``iters_big``).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
import traceback

METRIC = "icp_iter_per_s_cow"
BASELINE_ITER_PER_S = 187.0
# The gate, from JAX's headline run (BENCH_r05.json: err 2.691e-6 in 7
# iterations, RMSE 1.732e-6 against cow_ref).
GATE_ITERS = 7
GATE_ERR = 2.7e-6
# The RMSE bound a device: the card's kernels land at 1.696e-6, below
# 1.7e-6; the CPU's plain versions (bcast, eigh) at 1.7207e-6 and JAX's own
# run at 1.732e-6, so the CPU, which only the tests run, is held to
# 1.75e-6.  Either bound rejects a registration that stops short (the
# gate's err bound) or lands off cow_ref by more than ~1% of this figure.
GATE_RMSE = {"cuda": 1.7e-6, "cpu": 1.75e-6}
ITERS = (20, 520)  # the loop's two iteration counts, differenced

PHASE_MARK = "[bench:phase]"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _device_arg(argv) -> str:
    return argv[argv.index("--device") + 1] if "--device" in argv else "cuda"


def _error_line(msg: str) -> str:
    return json.dumps({"metric": METRIC, "value": 0.0, "unit": "iter/s",
                       "vs_baseline": 0.0, "error": msg})


# --------------------------------------------------------------------------
# Child: the measurement (runs in its own process group)
# --------------------------------------------------------------------------

def _phase(name: str) -> None:
    print(f"{PHASE_MARK} {name}", file=sys.stderr, flush=True)
    if os.environ.get("ICP_BENCH_TEST_HANG") == name:
        time.sleep(3600)  # test hook: a hang in this phase
    once = os.environ.get("ICP_BENCH_TEST_HANG_ONCE_FILE")
    if once and name == "init" and os.path.exists(once):
        os.remove(once)  # test hook: hang the FIRST attempt only
        time.sleep(3600)


def _test_iters(device: str):
    """The loop's (small, big) counts: ``ITERS``, or the test hook's, which
    only the CPU takes (None where the hook is refused)."""
    hook = os.environ.get("ICP_BENCH_TEST_ITERS")
    if not hook:
        return ITERS
    if device == "cuda":
        return None
    small, big = (int(k) for k in hook.split(","))
    return small, big


def measure(device: str) -> int:
    """The child's run; with ``ICP_BENCH_TEST_DROP_VERDICT`` it loses its
    verdict line (whatever it was) and exits 0."""
    if not os.environ.get("ICP_BENCH_TEST_DROP_VERDICT"):
        return _measure(device, print)
    _measure(device, lambda *a, **k: None)
    return 0  # test hook: rc 0 with no JSON verdict (lost stdout)


def _measure(device: str, verdict) -> int:
    # imports while the parent still counts the spawn phase: the init
    # watchdog times the device and the data alone
    import numpy as np
    import torch

    from icp_tpu_torch.bench.harness import (
        LOOP_PATHS,
        card_identity,
        load_cow,
        loop_per_iter,
    )
    from icp_tpu_torch.bench.roofline import (
        chip_spec,
        iteration_mfu_pct,
        nn_bound_pairs_per_s,
    )
    from icp_tpu_torch.config import ICPConfig
    from icp_tpu_torch.engine.icp import icp
    from icp_tpu_torch.io.native import get_lib

    # the CSV loader's one-time g++ build (a fresh checkout has none) is
    # set-up like the imports, whose time on a loaded host is no measure
    # of the device or the data
    get_lib()

    _phase("init")
    on_card = device == "cuda"
    if on_card and not torch.cuda.is_available():
        verdict(_error_line("no CUDA device (pass --device cpu for the CPU)"), flush=True)
        return 1
    dev = torch.device(device)
    float(torch.zeros((), device=dev))  # the device answers a scalar fetch

    ref_np, tr1_np = load_cow()
    ref = torch.as_tensor(ref_np, dtype=torch.float32, device=dev)
    tr1 = torch.as_tensor(tr1_np, dtype=torch.float32, device=dev)
    solver = "qcp_fused" if on_card else "eigh"
    nn_method = "pallas" if on_card else "bcast"

    _phase("gate")
    # the registered cloud must land on cow_ref (cow_tr1 is an exact
    # transform of it): BASELINE.json's alignment RMSE
    try:
        res = icp(ref_np, tr1_np, ICPConfig(max_iter=30, solver=solver, nn_method=nn_method),
                  device=dev)
        err, iters = float(res.err), int(res.iters)
    except Exception as e:  # a kernel that fails to build or launch
        traceback.print_exc()
        verdict(_error_line(f"gate failed: {type(e).__name__}: {e}"), flush=True)
        return 1
    pts = res.points.cpu().numpy()
    rmse = float(np.sqrt(np.mean(np.sum((pts - ref_np) ** 2, axis=1))))
    print(f"[bench] convergence gate: err={err:.3e} iters={iters} "
          f"alignment_rmse_vs_ref={rmse:.3e}", file=sys.stderr, flush=True)
    if not (iters == GATE_ITERS and err <= GATE_ERR and rmse <= GATE_RMSE[device]):
        verdict(_error_line(f"gate: err={err} iters={iters} rmse={rmse} (want {GATE_ITERS} "
                            f"iterations, err <= {GATE_ERR}, rmse <= {GATE_RMSE[device]})"),
                flush=True)
        return 1

    _phase("measure")
    # Three passes a path, the paths interleaved in each; ``value`` is the
    # best pass (the card's capability), the spread beside it.
    paths = LOOP_PATHS if on_card else ("pipeline",)
    small, big = _test_iters(device)
    reps = 8 if on_card else 3
    runs = {name: [] for name in LOOP_PATHS}
    for _ in range(3):
        for name in paths:
            try:
                per, _ = loop_per_iter(ref, tr1, name, small, big, reps)
            except Exception as e:
                traceback.print_exc()
                verdict(_error_line(f"{name} path failed: {type(e).__name__}: {e}"), flush=True)
                return 1
            if per <= 0:
                verdict(_error_line(f"{name} path unresolved: {big - small} iterations "
                                    f"took {per * (big - small) * 1e6:.1f} us"), flush=True)
                return 1
            runs[name].append(per)
    for acc in runs.values():
        acc.sort()
    path = min((p for p in runs if runs[p]), key=lambda p: runs[p][0])
    best_runs = runs[path]
    per_iter = best_runs[0]
    median = best_runs[len(best_runs) // 2]
    spread_pct = 100.0 * (best_runs[-1] - best_runs[0]) / best_runs[0]
    value = 1.0 / per_iter
    # Utilization of the DENSE iteration only (fused or pipeline passes),
    # against K3's whole-iteration bound (``mfu_pct``) and the NN fold's
    # (``mfu_nn_pct``): a grid iteration does a fraction of the dense work by
    # design, so it is never graded against the dense bound.
    name, power = card_identity() if on_card else (None, None)
    spec = chip_spec(torch.cuda.get_device_name(dev)) if on_card else None
    dense = sorted(runs["fused"] + runs["pipeline"])
    mfu = mfu_nn = None
    if spec is not None and dense:
        # icp_fixed_iters(ref, tr1): ref is the MODEL, tr1 the SCENE
        mfu = iteration_mfu_pct(spec, tr1.shape[0], ref.shape[0], dense[0])
        mfu_nn = round(100.0 * ref.shape[0] * tr1.shape[0] / dense[0]
                       / nn_bound_pairs_per_s(spec, "closest_fused"), 1)
    print(f"[bench] per-iter best={per_iter*1e6:.2f} us, median={median*1e6:.2f} us, "
          f"spread={spread_pct:.1f}%, mfu_iter={mfu}% (mfu_nn={mfu_nn}%) "
          f"(device={dev}, nn={nn_method}, solver={solver}, path={path})",
          file=sys.stderr, flush=True)
    _phase("done")
    verdict(json.dumps({
        "metric": METRIC,
        "value": round(value, 1),
        "unit": "iter/s",
        "vs_baseline": round(value / BASELINE_ITER_PER_S, 2),
        "iter_per_s_median": round(1.0 / median, 1),
        "per_iter_us_runs": [round(r * 1e6, 3) for r in best_runs],
        "spread_pct": round(spread_pct, 1),
        "mfu_pct": mfu,
        "mfu_nn_pct": mfu_nn,
        "path": path,
        "per_iter_us_fused": [round(r * 1e6, 3) for r in runs["fused"]],
        "per_iter_us_pipeline": [round(r * 1e6, 3) for r in runs["pipeline"]],
        "per_iter_us_grid": [round(r * 1e6, 3) for r in runs["grid"]],
        "iters_small": small,
        "iters_big": big,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "power_limit_w": power,
    }), flush=True)
    return 0


# --------------------------------------------------------------------------
# Parent: watchdog supervisor
# --------------------------------------------------------------------------

class _Attempt:
    def __init__(self) -> None:
        self.phase = "spawn"
        self.phase_t0 = time.time()
        self.stderr_tail: list[str] = []
        self.rc: int | None = None
        self.json_line: str | None = None
        self.failure: str | None = None

    def summary(self) -> dict:
        return {
            "phase": self.phase,
            "phase_elapsed_s": round(time.time() - self.phase_t0, 1),
            "rc": self.rc,
            "failure": self.failure,
            "stderr_tail": self.stderr_tail[-6:],
        }


def _drain_stderr(pipe, attempt: _Attempt) -> None:
    for raw in iter(pipe.readline, b""):
        line = raw.decode("utf-8", "replace").rstrip()
        if line.startswith(PHASE_MARK):
            attempt.phase = line[len(PHASE_MARK):].strip()
            attempt.phase_t0 = time.time()
        else:
            attempt.stderr_tail.append(line)
            if len(attempt.stderr_tail) > 50:
                del attempt.stderr_tail[:25]
        print(line, file=sys.stderr, flush=True)
    pipe.close()


def _run_attempt(deadline: float, phase_timeouts: dict[str, float], device: str) -> _Attempt:
    import threading

    attempt = _Attempt()
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--measure", "--device", device],
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        start_new_session=True,  # own process group: killable without patterns
    )
    reader = threading.Thread(target=_drain_stderr, args=(child.stderr, attempt),
                              daemon=True)
    reader.start()
    try:
        while True:
            rc = child.poll()
            if rc is not None:
                attempt.rc = rc
                break
            now = time.time()
            budget = phase_timeouts.get(attempt.phase, 600.0)
            if now - attempt.phase_t0 > budget:
                attempt.failure = f"watchdog: phase '{attempt.phase}' exceeded {budget:.0f}s"
                break
            if now > deadline:
                attempt.failure = "total benchmark budget exhausted"
                break
            time.sleep(0.2)
    finally:
        if attempt.failure is not None:
            try:  # kill the exact child process group (never by pattern)
                os.killpg(os.getpgid(child.pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
            child.wait()
            attempt.rc = child.returncode
    out = child.stdout.read().decode("utf-8", "replace")
    child.stdout.close()
    reader.join(timeout=5.0)
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("{"):
            attempt.json_line = line
    if attempt.failure is None and attempt.json_line is None:
        # rc != 0 AND the pathological rc 0 with no verdict (stdout lost):
        # the diagnostic JSON must always carry a non-null error
        attempt.failure = f"child exited rc={attempt.rc} without a JSON verdict"
    return attempt


def supervise(device: str) -> int:
    t0 = time.time()
    deadline = t0 + _env_float("ICP_BENCH_TOTAL_TIMEOUT", 2700.0)
    attempts_max = int(_env_float("ICP_BENCH_ATTEMPTS", 2))
    backoff = _env_float("ICP_BENCH_BACKOFF", 20.0)
    phase_timeouts = {
        "spawn": 120.0,
        "init": _env_float("ICP_BENCH_INIT_TIMEOUT", 600.0),
        "gate": _env_float("ICP_BENCH_GATE_TIMEOUT", 1200.0),
        "measure": _env_float("ICP_BENCH_MEASURE_TIMEOUT", 1500.0),
        "done": 120.0,
    }

    history: list[dict] = []
    for i in range(attempts_max):
        print(f"[bench] attempt {i + 1}/{attempts_max}", file=sys.stderr, flush=True)
        attempt = _run_attempt(deadline, phase_timeouts, device)
        history.append(attempt.summary())
        if attempt.json_line is not None:
            # the child's verdict (a result OR a structured failure), passed
            # through verbatim with the child's rc
            print(attempt.json_line, flush=True)
            return attempt.rc or 0
        print(f"[bench] attempt {i + 1} failed: {attempt.failure}", file=sys.stderr, flush=True)
        if time.time() + backoff > deadline:
            break
        if i + 1 < attempts_max:
            time.sleep(backoff)

    print(json.dumps({
        "metric": METRIC,
        "value": 0.0,
        "unit": "iter/s",
        "vs_baseline": 0.0,
        "error": history[-1]["failure"] if history else "no attempt ran",
        "diagnostic": {
            "elapsed_s": round(time.time() - t0, 1),
            "attempts": history,
        },
    }), flush=True)
    return 1


def main() -> int:
    device = _device_arg(sys.argv)
    if device not in ("cuda", "cpu"):
        print(f"bench_torch: --device cuda or cpu, not {device!r}", file=sys.stderr)
        return 2
    if _test_iters(device) is None:
        print(_error_line("ICP_BENCH_TEST_ITERS is a test hook of --device cpu: the headline "
                          f"is taken at {ITERS[0]} and {ITERS[1]} iterations"), flush=True)
        return 1
    if "--measure" in sys.argv:
        return measure(device)
    return supervise(device)


if __name__ == "__main__":
    sys.exit(main())
