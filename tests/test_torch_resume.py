"""Warm start and kill-safe resume in the port (``tests/test_resume.py``).

  * ``icp_resumable`` killed after one chunk and resumed reproduces the
    uninterrupted chunked run bit for bit (points, transform, error,
    iterations), on the plain float64 path and on the fused float32 path
    (K3's plain version), and the chunks of 4, 4, 2 equal one run of 10
    within atol 1e-12 (float64: chunking composes per chunk).
  * A run resumed past ``max_iter`` re-applies the stored transform and
    keeps the stored error.
  * The CLI's ``--checkpoint-every`` and ``--resume``.
  * Across packages: a checkpoint that JAX's ``icp_resumable`` writes after
    one chunk, resumed by the port, ends at JAX's uninterrupted chunked
    result (the same iterations, points within atol 1e-9 in float64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_tpu
from icp_tpu.engine.icp import icp_resumable as j_resumable
from icp_tpu_torch import ICPConfig, Similarity, icp
from icp_tpu_torch.engine.cli import main
from icp_tpu_torch.engine.icp import icp_resumable
from icp_tpu_torch.utils.checkpoint import load_checkpoint
from tests.conftest import data_path


def _cfg(**kw):
    base = dict(max_iter=60, dtype=torch.float64, solver="eigh", nn_method="bcast")
    base.update(kw)
    return ICPConfig(**base)


def test_icp_init_warm_start_converges_immediately(cow_pair):
    ref, tr1 = cow_pair
    full = icp(ref, tr1, _cfg(), device="cpu")
    warm = icp(ref, tr1, _cfg(), init=full.transform, device="cpu")
    assert int(warm.iters) <= 2
    np.testing.assert_allclose(warm.transform.R.numpy(), full.transform.R.numpy(), atol=1e-9)
    np.testing.assert_allclose(warm.points.numpy(), full.points.numpy(), atol=1e-9)


@pytest.mark.parametrize("cfg", [dict(), dict(dtype=torch.float32, solver="qcp_fused",
                                              nn_method="pallas", max_iter=20)],
                         ids=["plain_float64", "fused_float32"])
def test_kill_and_resume_bit_for_bit(cow_pair, tmp_path, cfg):
    ref, tr1 = cow_pair
    ck_a, ck_b = str(tmp_path / "uninterrupted.npz"), str(tmp_path / "killed.npz")
    full = icp_resumable(ref, tr1, _cfg(**cfg), checkpoint_path=ck_a, checkpoint_every=3,
                         device="cpu")
    icp_resumable(ref, tr1, _cfg(**dict(cfg, max_iter=3)), checkpoint_path=ck_b,
                  checkpoint_every=3, device="cpu")
    assert load_checkpoint(ck_b)[1] == 3
    resumed = icp_resumable(ref, tr1, _cfg(**cfg), checkpoint_path=ck_b, checkpoint_every=3,
                            resume=True, device="cpu")
    assert int(resumed.iters) == int(full.iters) > 3
    assert torch.equal(resumed.points, full.points)
    for a, b in zip(resumed.transform, full.transform):
        assert torch.equal(a, b)
    assert float(resumed.err) == float(full.err)


def test_resumable_partial_chunk_matches_one_run(cow_pair, tmp_path):
    ref, tr1 = cow_pair
    ref, tr1 = np.ascontiguousarray(ref[::10]), np.ascontiguousarray(tr1[::10])
    cfg = _cfg(max_iter=10, threshold=0.0)  # never converges: chunks of 4, 4, 2
    res = icp_resumable(ref, tr1, cfg, checkpoint_path=str(tmp_path / "c.npz"),
                        checkpoint_every=4, device="cpu")
    assert int(res.iters) == 10
    mono = icp(ref, tr1, cfg, device="cpu")
    np.testing.assert_allclose(res.points.numpy(), mono.points.numpy(), atol=1e-12)


def test_resume_past_max_iter_keeps_the_stored_error(cow_pair, tmp_path):
    ref, tr1 = cow_pair
    ck = str(tmp_path / "c.npz")
    first = icp_resumable(ref, tr1, _cfg(max_iter=4, threshold=0.0), checkpoint_path=ck,
                          checkpoint_every=4, device="cpu")
    again = icp_resumable(ref, tr1, _cfg(max_iter=4, threshold=0.0), checkpoint_path=ck,
                          checkpoint_every=4, resume=True, device="cpu")
    assert int(again.iters) == 4 and float(again.err) == float(first.err)
    np.testing.assert_allclose(again.points.numpy(), first.points.numpy(), atol=1e-12)


def test_cli_resume_roundtrip(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ck, out = str(tmp_path / "ck.npz"), str(tmp_path / "out.txt")
    args = [data_path("cow_ref.txt"), data_path("cow_tr1.txt")]
    flags = ["--checkpoint", ck, "--checkpoint-every", "4", "--output", out, "--solver",
             "eigh", "--nn", "bcast", "--device", "cpu"]
    assert main([*args, "4", *flags]) == 0  # interrupted: 4 iterations allowed
    assert load_checkpoint(ck)[1] == 4
    assert main([*args, "60", *flags, "--resume"]) == 0  # resumed to convergence
    _, iters, err, _ = load_checkpoint(ck)
    assert iters > 4 and err < 1e-5


def test_jax_checkpoint_resumes_in_the_port(cow_pair, tmp_path):
    ref, tr1 = cow_pair
    jcfg = dict(max_iter=30, dtype=jnp.float64, solver="eigh", nn_method="bcast")
    want = j_resumable(ref, tr1, icp_tpu.ICPConfig(**jcfg),
                       checkpoint_path=str(tmp_path / "j_full.npz"), checkpoint_every=3)
    ck = str(tmp_path / "j_killed.npz")
    j_resumable(ref, tr1, icp_tpu.ICPConfig(**dict(jcfg, max_iter=3)), checkpoint_path=ck,
                checkpoint_every=3)
    got = icp_resumable(ref, tr1, _cfg(max_iter=30), checkpoint_path=ck, checkpoint_every=3,
                        resume=True, device="cpu")
    assert int(got.iters) == int(want.iters) > 3
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), atol=1e-9)
    np.testing.assert_allclose(got.transform.R.numpy(), np.asarray(want.transform.R), atol=1e-9)


def test_init_accepts_the_checkpoint_similarity(cow_pair, tmp_path):
    """``load_checkpoint``'s float64 CPU Similarity is a valid ``init``."""
    ref, tr1 = cow_pair
    ck = str(tmp_path / "c.npz")
    icp_resumable(ref, tr1, _cfg(max_iter=2, threshold=0.0), checkpoint_path=ck,
                  checkpoint_every=2, device="cpu")
    sim, _, _, _ = load_checkpoint(ck)
    assert isinstance(sim, Similarity) and sim.R.dtype == torch.float64
    res = icp(ref, tr1, _cfg(dtype=torch.float32), init=sim, device="cpu")
    assert res.transform.R.dtype == torch.float32 and float(res.err) < 1e-5
