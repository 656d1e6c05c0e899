"""The port's CLI (``icp_tpu_torch.engine.cli``) as a subprocess, on the CPU.

Reference contract (``src/main.cc``): usage -> exit 255, unopenable file ->
exit 2, ``[ICP] iteration number i | error value = e`` lines on stderr and
``output.txt`` with the header row.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from icp_tpu_torch.io.csv import load_matrix
from icp_tpu_torch.utils.checkpoint import load_checkpoint
from tests.conftest import data_path
from tests.test_golden_reference import _TRACE_RE, reference_output, reference_trace

ENV = dict(os.environ, JAX_PLATFORMS="cpu")


def run_cli(args, cwd, env=ENV):
    return subprocess.run([sys.executable, "-m", "icp_tpu_torch.engine.cli", *args],
                          capture_output=True, text=True, cwd=cwd, env=env, timeout=600)


def test_cli_cpu_run_matches_reference_binary(tmp_path):
    r = run_cli([data_path("cow_ref.txt"), data_path("cow_tr1.txt"), "10", "--device", "cpu",
                 "--nn", "pallas", "--solver", "qcp_fused"], tmp_path)
    assert r.returncode == 0, r.stderr
    pairs = _TRACE_RE.findall(r.stderr)
    assert [int(i) for i, _ in pairs] == list(range(7))
    got = np.array([float(e) for _, e in pairs])
    want = np.array(reference_trace("cow_tr1"))
    np.testing.assert_allclose(got[want > 1e-6], want[want > 1e-6], rtol=1e-2)
    assert '[output] output file "output.txt" was generated.' in r.stderr
    with open(tmp_path / "output.txt") as f:
        lines = f.read().splitlines()
    assert lines[0] == "Points_0,Points_1,Points_2" and len(lines) == 2904
    np.testing.assert_allclose(load_matrix(str(tmp_path / "output.txt")),
                               reference_output("cow_tr1"), atol=1e-5)


def test_usage_on_missing_args(tmp_path):
    r = run_cli([], tmp_path)
    assert "Usage:" in r.stdout
    assert r.returncode == 255


def test_missing_file_exit_2(tmp_path):
    r = run_cli([str(tmp_path / "a.txt"), str(tmp_path / "b.txt"), "5", "--device", "cpu"],
                tmp_path)
    assert r.returncode == 2
    assert "could not be opened" in r.stderr


def test_unequal_counts_exit_255(tmp_path):
    small = tmp_path / "small.txt"
    small.write_text("x,y,z\n" + "\n".join(f"{i},{i * i},1" for i in range(10)) + "\n")
    r = run_cli([data_path("cow_ref.txt"), str(small), "5", "--device", "cpu"], tmp_path)
    assert r.returncode == 255
    assert "same number of points" in r.stderr


def test_cli_sharded_checkpoint_saves_the_run(tmp_path):
    """``--sharded --checkpoint`` runs the sharded engine and saves its
    result, as JAX's CLI: the iterations, the error and the transform that
    maps the scene onto ``output.txt``."""
    r = run_cli([data_path("cow_ref.txt"), data_path("cow_tr1.txt"), "10", "--device", "cpu",
                 "--sharded", "--checkpoint", "ck.npz"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert "[checkpoint] saved to ck.npz" in r.stderr
    sim, iters, err, _ = load_checkpoint(str(tmp_path / "ck.npz"))
    assert iters == r.stderr.count("[ICP] iteration number") == 7 and err < 1e-5
    scene = load_matrix(data_path("cow_tr1.txt"))
    moved = float(sim.s) * scene @ sim.R.numpy().T + sim.t.numpy()
    np.testing.assert_allclose(load_matrix(str(tmp_path / "output.txt")), moved, atol=1e-5)
    np.testing.assert_allclose(load_matrix(str(tmp_path / "output.txt")),
                               reference_output("cow_tr1"), atol=1e-5)


@pytest.mark.parametrize("flags,msg", [
    (["--sharded", "--metrics", "m.json"], "--sharded and --metrics cannot be combined"),
    (["--sharded", "--checkpoint", "c.npz", "--checkpoint-every", "3"],
     "--checkpoint-every/--resume and --sharded cannot be combined"),
    (["--sharded", "--checkpoint", "c.npz", "--resume", "--engine", "gicp"],
     "--checkpoint-every/--resume and --sharded cannot be combined"),
])
def test_cli_sharded_refusals_are_jax_s(tmp_path, flags, msg):
    """``--sharded`` excludes the other run modes, with JAX's messages and
    exit code (``icp_tpu/engine/cli.py:116-134``)."""
    r = run_cli([data_path("cow_ref.txt"), data_path("cow_tr1.txt"), "3", "--device", "cpu",
                 *flags], tmp_path)
    assert r.returncode == 255
    assert msg in r.stderr
    assert not (tmp_path / "output.txt").exists()


def test_cuda_device_without_cuda_exits_nonzero(tmp_path):
    env = dict(ENV, CUDA_VISIBLE_DEVICES="")  # no card, whatever the machine
    r = run_cli([data_path("cow_ref.txt"), data_path("cow_tr1.txt"), "3"], tmp_path, env)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not (tmp_path / "output.txt").exists()
