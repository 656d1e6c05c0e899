"""The port's multi-process bring-up on the CPU: ``init_distributed`` over
tcp with two gloo ranks, ``icp-torch --sharded`` under ``torchrun``, and
``bundle_adjust_sharded``, against JAX's two-device runs and the reference
binary's fixture.

The ranks run once for the module (``tests/torch_dist_worker.py``, suite
``distributed``); each joins the group through ``init_distributed`` over
``tcp://localhost:<free port>``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import icp_tpu
from icp_tpu.ops.alignment import Similarity as JSimilarity
from icp_tpu.parallel.mesh import make_mesh as j_make_mesh
from icp_tpu.parallel.sharded import icp_sharded as j_icp_sharded
from icp_tpu.slam.pose_graph import bundle_adjust_sharded as j_bundle_adjust_sharded
from icp_tpu_torch.io.csv import load_matrix
from tests.conftest import data_path
from tests.test_golden_reference import _TRACE_RE, reference_output, reference_trace
from tests.torch_dist_worker import ROOT, ba_case, cow_pair, run_ranks

WORLD = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("distributed", WORLD, tmp_path_factory.mktemp("distributed"))


@pytest.fixture(scope="module")
def jmesh():
    return j_make_mesh(jax.devices()[:WORLD])


def test_init_distributed_two_process_ring_matches_jax(ranks, jmesh):
    """Both ranks report the same replicated result, and it is JAX's
    two-device run of the same program."""
    for k, v in ranks[0]["ring"].items():
        np.testing.assert_array_equal(ranks[1]["ring"][k], v, err_msg=k)
    ref, tr1 = cow_pair(20)
    cfg = icp_tpu.ICPConfig(max_iter=20, dtype=jnp.float64, solver="eigh", nn_method="bcast")
    want = j_icp_sharded(ref, tr1, cfg, mesh=jmesh)
    got = ranks[0]["ring"]
    assert int(got["iters"]) == int(want.iters)
    np.testing.assert_allclose(float(got["err"]), float(want.err), rtol=1e-9)
    np.testing.assert_allclose(got["points"], np.asarray(want.points), rtol=0, atol=1e-9)


def test_a_mesh_serves_only_its_own_device(ranks, monkeypatch):
    """A gloo mesh refuses clouds on another device type, a gloo group
    refuses to serve the card, and with no card ``make_mesh()`` raises
    rather than moving to the CPU."""
    import torch

    from icp_tpu_torch.parallel.mesh import make_mesh

    msgs = ranks[0]["refusals"]
    assert "a cloud is on 'meta' but the mesh is on 'cpu'" in str(msgs["cloud"])
    assert "does not serve cuda tensors" in str(msgs["backend"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices='cpu'"):
        make_mesh()


def test_bundle_adjust_sharded_matches_jax(ranks, jmesh):
    """The normal equations all-reduced over two ranks: the single-device
    port's poses within 1e-6 (float32 sums in another order) and JAX's
    sharded run's within 1e-5, the costs within rtol 1e-4."""
    poses, corr = ba_case()
    jposes = [JSimilarity(s=jnp.asarray(1.0, jnp.float32), R=jnp.asarray(R, jnp.float32),
                          t=jnp.asarray(t, jnp.float32)) for R, t in poses]
    want, want_cost = j_bundle_adjust_sharded(jposes, corr, mesh=jmesh)
    got, single = ranks[0]["ba_sharded"], ranks[0]["ba_single"]
    for k in ("R", "t"):
        np.testing.assert_array_equal(ranks[1]["ba_sharded"][k], got[k])
        np.testing.assert_allclose(got[k], single[k], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[k], np.stack([np.asarray(getattr(p, k)) for p in want]),
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(got["cost"]), want_cost, rtol=1e-4)
    np.testing.assert_allclose(float(got["cost"]), float(single["cost"]), rtol=1e-4)


def test_torchrun_cli_sharded_matches_reference_binary(tmp_path):
    """``icp-torch --device cpu --sharded`` on two ranks under ``torchrun``:
    rank 0 alone prints the trace (7 iterations, the binary's within rtol
    1e-2 on entries > 1e-6) and writes ``output.txt`` (within 1e-5 of the
    binary's)."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", str(WORLD), "-m", "icp_tpu_torch.engine.cli",
                        data_path("cow_ref.txt"), data_path("cow_tr1.txt"), "10",
                        "--device", "cpu", "--sharded"],
                       capture_output=True, text=True, cwd=tmp_path, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    pairs = _TRACE_RE.findall(r.stderr)
    assert [int(i) for i, _ in pairs] == list(range(7))  # one rank's lines
    got = np.array([float(e) for _, e in pairs])
    want = np.array(reference_trace("cow_tr1"))
    np.testing.assert_allclose(got[want > 1e-6], want[want > 1e-6], rtol=1e-2)
    assert r.stderr.count('[output] output file "output.txt" was generated.') == 1
    assert sorted(os.listdir(tmp_path)) == ["output.txt"]
    np.testing.assert_allclose(load_matrix(str(tmp_path / "output.txt")),
                               reference_output("cow_tr1"), atol=1e-5)
