"""The port's ``icp-slam-torch`` (``icp_tpu_torch.slam.cli``) as a
subprocess on the CPU, against the JAX ``icp-slam`` CLI's run on the five
bunny scans (``tests/fixtures/torch_slam/``, made by
``scripts/make_torch_fixtures.py torch_slam``).

Held: the same closure candidates (pairs and inlier fractions to two
places), each chain pair's iterations, its trimmed error within rtol 1e-3,
the same suspect chain edges (the lines naming them equal), the pose
graph's cost within rtol 1e-3, the saved poses within 1e-4 (R) and 1e-5
(t), and each output cloud within 1e-5 of its full scan moved by the
fixture's pose: RANSAC draws different triplets in the two packages, and
the closure's ICP refinement lands both on the same pose to float32 noise
(3.5e-6 and 3.9e-7 measured).
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from icp_tpu_torch.io.csv import load_matrix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_slam")
_PAIR_RE = re.compile(r"\[slam\] pair (\d+)->(\d+): iters=(\d+) err=(\S+)")
_CLOSURE_RE = re.compile(r"\[slam\] closure candidate (\d+)<-(\d+): inliers=(\S+)")
_SUSPECT_RE = re.compile(r"\[slam\] chain edge \d+->\d+ is unverifiable .*")
_COST_RE = re.compile(r"\[slam\] pose graph: (\d+) closure edge\(s\), cost=(\S+)")


def _fixture_command():
    """The scans and flags of the fixture's run, from its README."""
    with open(os.path.join(FIXTURE, "README.md")) as f:
        line = next(ln for ln in f if "icp_tpu.slam.cli" in ln)
    args = line.split("icp_tpu.slam.cli", 1)[1].split()
    return [os.path.join(ROOT, a) if a.startswith("data/") else a for a in args]


def _run(args, cwd):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", "icp_tpu_torch.slam.cli", *args],
                          capture_output=True, text=True, cwd=cwd, env=env, timeout=600)


def test_slam_cli_cpu_matches_the_jax_fixture(tmp_path):
    r = _run(_fixture_command() + ["--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(os.path.join(FIXTURE, "stderr.txt")) as f:
        want = f.read()
    got_pairs, want_pairs = _PAIR_RE.findall(r.stderr), _PAIR_RE.findall(want)
    assert len(got_pairs) == len(want_pairs) == 4
    for g, w in zip(got_pairs, want_pairs):
        assert g[:3] == w[:3]  # pair and iterations
        np.testing.assert_allclose(float(g[3]), float(w[3]), rtol=1e-3)
    assert _CLOSURE_RE.findall(r.stderr) == _CLOSURE_RE.findall(want) == [("0", "4", "0.20")]
    assert "pose graph: 1 closure edge(s)" in r.stderr
    assert _SUSPECT_RE.findall(r.stderr) == _SUSPECT_RE.findall(want)
    assert len(_SUSPECT_RE.findall(want)) == 3
    (got_n, got_cost), = _COST_RE.findall(r.stderr)
    (want_n, want_cost), = _COST_RE.findall(want)
    assert got_n == want_n == "1"
    np.testing.assert_allclose(float(got_cost), float(want_cost), rtol=1e-3)
    poses, ref = np.load(tmp_path / "poses.npz"), np.load(os.path.join(FIXTURE, "poses.npz"))
    np.testing.assert_array_equal(poses["s"], ref["s"])
    np.testing.assert_allclose(poses["R"], ref["R"], atol=1e-4)
    np.testing.assert_allclose(poses["t"], ref["t"], atol=1e-5)
    scans = [a for a in _fixture_command() if a.endswith(".txt")]
    assert len(scans) == 5
    for k, scan in enumerate(scans):
        moved = ref["s"][k] * load_matrix(scan) @ ref["R"][k].T + ref["t"][k]
        np.testing.assert_allclose(load_matrix(str(tmp_path / f"registered_{k}.txt")), moved,
                                   rtol=0, atol=1e-5, err_msg=f"registered_{k}.txt")


def test_slam_cli_device_cuda_without_a_card_exits_minus_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    scans = [os.path.join(ROOT, "data", f"bun{v}.txt") for v in ("000", "045")]
    r = _run(scans, tmp_path)  # --device cuda is the default
    assert r.returncode == 255
    assert "no CUDA device" in r.stderr
    assert not (tmp_path / "poses.npz").exists()


def test_slam_cli_needs_two_scans(tmp_path):
    r = _run([os.path.join(ROOT, "data", "bun000.txt"), "--device", "cpu"], tmp_path)
    assert r.returncode == 255 and "need at least 2 scans" in r.stderr
