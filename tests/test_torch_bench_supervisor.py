"""``bench_torch.py``'s supervisor on the CPU (``--device cpu``): the
watchdog, the retry, the verdict always carried by one JSON line, and no
run on the CPU unless asked.  Small ``ICP_BENCH_*`` timeouts and the
``ICP_BENCH_TEST_ITERS`` hook (the CPU's only) keep each run to seconds;
the success path at the real iteration counts is the one slow test."""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHORT = {"ICP_BENCH_TEST_ITERS": "1,2"}
# three iterations apart: resolved on a host shared with other test workers
RESOLVED = {"ICP_BENCH_TEST_ITERS": "1,4"}


def _run_bench(extra_env, device="cpu", timeout=300):
    env = {k: v for k, v in os.environ.items() if not k.startswith("ICP_BENCH_")}
    env.update(extra_env)
    args = [sys.executable, os.path.join(ROOT, "bench_torch.py")]
    if device is not None:
        args += ["--device", device]
    return subprocess.run(args, capture_output=True, text=True, env=env, timeout=timeout,
                          cwd=ROOT)


def _verdict(proc) -> dict:
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, proc.stdout
    return json.loads(lines[0])


def test_watchdog_kills_a_hung_init_and_diagnoses():
    proc = _run_bench({"ICP_BENCH_TEST_HANG": "init", "ICP_BENCH_INIT_TIMEOUT": "2",
                       "ICP_BENCH_ATTEMPTS": "2", "ICP_BENCH_BACKOFF": "0.5"}, timeout=120)
    assert proc.returncode == 1
    rec = _verdict(proc)
    assert rec["value"] == 0.0 and "watchdog" in rec["error"]
    attempts = rec["diagnostic"]["attempts"]
    assert len(attempts) == 2 and all(a["phase"] == "init" for a in attempts)


def test_retry_recovers_from_one_bad_attempt(tmp_path):
    """The first attempt hangs in init (the flag file), the watchdog kills
    it, the second runs clean: rc 0 and the headline record, from the
    CPU's one path, with the hook's iteration counts in it."""
    flag = tmp_path / "hang_once"
    flag.write_text("")
    proc = _run_bench({"ICP_BENCH_TEST_HANG_ONCE_FILE": str(flag), "ICP_BENCH_INIT_TIMEOUT": "10",
                       "ICP_BENCH_ATTEMPTS": "2", "ICP_BENCH_BACKOFF": "0.5", **RESOLVED})
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = _verdict(proc)
    assert rec["metric"] == "icp_iter_per_s_cow" and rec["value"] > 0
    assert rec["path"] == "pipeline" and rec["device"] == "cpu"
    assert len(rec["per_iter_us_pipeline"]) == 3 and rec["per_iter_us_fused"] == []
    assert rec["mfu_pct"] is None and rec["power_limit_w"] is None
    assert (rec["iters_small"], rec["iters_big"]) == (1, 4)
    assert "convergence gate: err=" in proc.stderr and "iters=7" in proc.stderr
    assert not flag.exists()


def test_rc0_without_verdict_diagnosed():
    """A child that exits 0 with no JSON verdict (lost stdout: the hook drops
    whatever verdict the run reached) still gives a non-null error in the
    diagnostic line."""
    proc = _run_bench({"ICP_BENCH_TEST_DROP_VERDICT": "1", "ICP_BENCH_ATTEMPTS": "1", **SHORT})
    assert proc.returncode == 1
    rec = _verdict(proc)
    assert rec["value"] == 0.0 and "without a JSON verdict" in rec["error"]


def test_iteration_hook_is_refused_on_the_card():
    """The short-run hook never times a headline: with ``--device cuda`` the
    run ends before it starts, one error line, rc 1."""
    proc = _run_bench(SHORT, device="cuda", timeout=120)
    assert proc.returncode == 1
    rec = _verdict(proc)
    assert rec["value"] == 0.0 and "ICP_BENCH_TEST_ITERS" in rec["error"]
    assert "[bench] attempt" not in proc.stderr


def test_no_card_ends_the_run_with_an_error_line():
    """With no argument it runs on the card; without one it does not fall
    back to the CPU: one error line, rc 1, and no retry of a verdict."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: this holds the run without one")
    proc = _run_bench({"ICP_BENCH_ATTEMPTS": "2", "ICP_BENCH_BACKOFF": "30"}, device=None,
                      timeout=120)
    assert proc.returncode == 1
    rec = _verdict(proc)
    assert rec["value"] == 0.0 and "no CUDA device" in rec["error"]
    assert proc.stderr.count("[bench] attempt") == 1


@pytest.mark.slow
def test_success_path_emits_one_json_line():
    proc = _run_bench({"ICP_BENCH_ATTEMPTS": "1"}, timeout=3600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = _verdict(proc)
    assert rec["metric"] == "icp_iter_per_s_cow" and rec["unit"] == "iter/s"
    assert rec["value"] > 0 and rec["vs_baseline"] > 0
