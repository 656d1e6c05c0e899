"""The port's utilities against the JAX package (``tests/test_utils.py``):
checkpoints (both directions across packages), ``check_finite``,
``trace``, ``run_with_metrics`` against JAX's record (the same iterations,
the errors within rtol 1e-9 on the float64 ``eigh`` path) and the CLI's run
modes (``--metrics``, ``--metrics-ops``, ``--checkpoint`` and JAX's mode
rules and messages)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_tpu
from icp_tpu.utils import checkpoint as jck
from icp_tpu_torch import ICPConfig, Similarity, icp
from icp_tpu_torch.engine.cli import main
from icp_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from icp_tpu_torch.utils.metrics import run_with_metrics
from icp_tpu_torch.utils.profiling import check_finite, trace
from tests.conftest import data_path


def _sim(dtype=torch.float32):
    return Similarity(s=torch.tensor(1.5, dtype=dtype), R=torch.eye(3, dtype=dtype),
                      t=torch.tensor([1.0, 2.0, 3.0], dtype=dtype))


def test_checkpoint_roundtrip(tmp_path):
    pts = np.random.default_rng(0).standard_normal((10, 3))
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, transform=_sim(), iteration=7, err=1e-6, points=pts)
    sim, it, err, pts2 = load_checkpoint(path)
    assert it == 7 and err == 1e-6
    assert float(sim.s) == 1.5 and torch.equal(sim.R, torch.eye(3, dtype=torch.float64))
    np.testing.assert_array_equal(pts2, pts)
    save_checkpoint(str(tmp_path / "ck2.npz"), transform=_sim(), iteration=1, err=0.5)
    assert load_checkpoint(str(tmp_path / "ck2.npz"))[3] is None


def test_checkpoints_cross_the_packages(tmp_path):
    """The same keys and types: a file either package writes loads in the
    other with the same values."""
    rng = np.random.default_rng(1)
    R = np.linalg.qr(rng.standard_normal((3, 3)))[0].astype(np.float32)
    t = rng.standard_normal(3).astype(np.float32)
    port_file, jax_file = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    save_checkpoint(port_file, transform=Similarity(torch.tensor(1.25), torch.tensor(R),
                                                    torch.tensor(t)), iteration=9, err=3e-7)
    jck.save_checkpoint(jax_file, transform=icp_tpu.Similarity(
        jnp.asarray(1.25, jnp.float32), jnp.asarray(R), jnp.asarray(t)), iteration=9, err=3e-7)
    with np.load(port_file) as a, np.load(jax_file) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    jsim, jit, jerr, _ = jck.load_checkpoint(port_file)
    psim, pit, perr, _ = load_checkpoint(jax_file)
    assert jit == pit == 9 and jerr == perr == 3e-7
    for a, b in zip(jsim, psim):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_check_finite_raises_with_context():
    check_finite("ok", torch.ones(3), np.ones(2))
    with pytest.raises(FloatingPointError, match="icp-step: array 1"):
        check_finite("icp-step", torch.ones(3), torch.tensor([1.0, float("nan")]))


def test_icp_guard_flag(cow_pair):
    ref, tr1 = cow_pair
    res = icp(ref[::50], tr1[::50], ICPConfig(max_iter=2, dtype=torch.float64), guard=True,
              device="cpu")
    assert np.isfinite(float(res.err))


def test_profiling_trace_smoke(tmp_path, capsys):
    """``trace`` writes a Chrome trace of its body, the section line, and
    the counters of its body alone (reset at its start) as
    ``counters.json``."""
    rng = np.random.default_rng(0)
    model = rng.standard_normal((200, 3))
    cfg = ICPConfig(max_iter=5, solver="eigh", nn_method="bcast")
    log_dir = str(tmp_path / "prof")
    with trace(str(tmp_path / "before")):
        icp(model, model + 0.01, cfg, device="cpu")
    with trace(log_dir):
        x = torch.ones((64, 64))
        assert float((x @ x).sum()) == 64 ** 3
        res = icp(model, model + 0.01, cfg, device="cpu")
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert {"icp.register", "icp.loop", "icp.host_wait"} <= {e.get("name") for e in events}
    assert "[profile] section took" in capsys.readouterr().err
    with open(os.path.join(log_dir, "counters.json")) as f:
        c = json.load(f)
    assert c["registrations"] == 1 and c["iters_done"] == int(res.iters)
    assert c["iters_launched"] == 5 and c["host_waits"] > 0
    assert {"icp.register", "icp.prologue", "icp.loop", "icp.finish"} == set(c["phase_ms"])


def test_run_with_metrics_matches_jax_record(cow_pair):
    from icp_tpu.utils.metrics import run_with_metrics as j_run_with_metrics

    ref, tr1 = cow_pair
    base = dict(max_iter=30, solver="eigh", nn_method="bcast")
    jtr, jrec = j_run_with_metrics(ref, tr1, icp_tpu.ICPConfig(dtype=jnp.float64, **base))
    tr, rec = run_with_metrics(ref, tr1, ICPConfig(dtype=torch.float64, **base),
                               measure_ops=True, device="cpu")
    assert rec.iters == jrec.iters == int(tr.result.iters)
    np.testing.assert_allclose(rec.errs, jrec.errs, rtol=1e-9)
    assert rec.errs[-1] < 1e-5 and rec.errs[0] > rec.errs[-1]
    d = json.loads(rec.to_json())
    assert sorted(d) == sorted(json.loads(jrec.to_json()))
    assert d["backend"] == "cpu" and d["solver"] == "eigh" and d["wall_s"] > 0
    assert d["correspondence_us"] > 0 and d["alignment_us"] > 0


def _cli(args, tmp_path, capsys):
    rc = main([data_path("cow_ref.txt"), data_path("cow_tr1.txt"), *args, "--device", "cpu",
               "--output", str(tmp_path / "out.txt")])
    return rc, capsys.readouterr().err


@pytest.mark.parametrize("nn", ["bcast", "grid"])
def test_cli_metrics_flag(tmp_path, capsys, nn):
    mpath = str(tmp_path / "metrics.json")
    rc, err = _cli(["30", "--metrics", mpath, "--metrics-ops", "--solver", "qcp_fused",
                    "--nn", nn], tmp_path, capsys)
    assert rc == 0 and f"[metrics] written to {mpath}" in err
    rec = json.loads(open(mpath).read())
    assert rec["iters"] == 7 and rec["err"] < 1e-5 and len(rec["errs"]) == rec["iters"]
    assert rec["nn_method"] == nn and rec["correspondence_us"] > 0 and rec["alignment_us"] > 0
    assert err.count("[ICP] iteration number") == 7


def test_cli_checkpoint_saves_a_plain_run(tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")
    rc, err = _cli(["10", "--checkpoint", ck, "--trim", "0.1"], tmp_path, capsys)
    assert rc == 0 and f"[checkpoint] saved to {ck}" in err
    _, iters, e, _ = load_checkpoint(ck)
    assert iters == err.count("[ICP] iteration number") == 8 and e < 1e-5


@pytest.mark.parametrize("flags,msg", [
    (["--resume"], "--checkpoint-every/--resume require --checkpoint PATH"),
    (["--checkpoint", "c.npz", "--resume", "--metrics", "m.json"],
     "--checkpoint-every/--resume and --metrics cannot be combined"),
    (["--engine", "gicp", "--metrics", "m.json"],
     "--engine gicp supports only the plain and --sharded run modes"),
])
def test_cli_run_mode_rules(tmp_path, capsys, flags, msg):
    rc, err = _cli(["10", *flags], tmp_path, capsys)
    assert rc == -1 and msg in err and not (tmp_path / "out.txt").exists()
