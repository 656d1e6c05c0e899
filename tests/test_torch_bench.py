"""The port's harness (``icp_tpu_torch/bench/``) held to the JAX package's
(``icp_tpu/bench/``) on the CPU: the host NumPy engine, the synthetic
scaling pair and the bundled pairs bit for bit, the timers on CPU
tensors, the op matrix's rows and keys, the pipeline switch of the loop
rows, and the scaling cell at one and two gloo ranks against JAX's
one- and two-device cells.  The ranks run in subprocesses
(``tests/torch_dist_worker.py``, suite ``bench``), once a world size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_tpu
from icp_tpu.bench import harness as j_harness
from icp_tpu.bench import scaling as j_scaling
from icp_tpu.parallel.mesh import make_mesh as j_make_mesh
from icp_tpu.parallel.sharded import icp_sharded as j_icp_sharded
from icp_tpu_torch.bench import harness, scaling
from tests.torch_dist_worker import cow_pair, run_ranks

# rows both packages run off their accelerator, quick on the CPU
MATRIX_ROWS = ["find_alignment", "compute_centroid", "full_loop_numpy"]
UTILIZATION = ("mfu_pct", "mfu_iter_pct", "hbm_util_pct", "bound_pairs_per_s",
               "vpu_bound_pairs_per_s")


@pytest.fixture(scope="module", params=[1, 2], ids=["world1", "world2"])
def bench_ranks(request, tmp_path_factory):
    return run_ranks("bench", request.param, tmp_path_factory.mktemp(f"bench{request.param}"))


def test_numpy_icp_bit_equal_to_jax():
    """The dual-engine row's host NumPy ICP is JAX's, bit for bit, and does
    real work: 15 iterations land cow's scene on the model."""
    ref, tr1 = harness.load_cow()
    ref, tr1 = ref[::10], tr1[::10]
    wall, p = harness._numpy_icp(ref, tr1, 15)
    _, want = j_harness._numpy_icp(ref, tr1, 15)
    assert wall > 0
    np.testing.assert_array_equal(p, want)
    assert np.abs(p - np.asarray(ref, np.float64)).max() < 1e-3


def test_synthetic_pair_bit_equal_to_jax():
    model, scene = scaling.synthetic_pair(256, 1024)
    j_model, j_scene = j_scaling.synthetic_pair(256, 1024)
    assert model.shape == (256, 3) and scene.shape == (1024, 3)
    np.testing.assert_array_equal(model, j_model)
    np.testing.assert_array_equal(scene, j_scene)
    assert not np.allclose(scene[:256], model)


@pytest.mark.parametrize("workload", ["cow", "horse"])
def test_load_pair_equals_jax(workload):
    got = harness.load_pair(workload)
    want = j_harness.load_pair(workload)
    for a, b in zip(got, want):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("inner", [1, 8])
def test_amortized_op_time_sane_and_chained_on_a_device_scalar(inner):
    """Each call gets the carry as a 0-d tensor on the inputs' device (never
    a host number), ``warm + reps x (n_small + n_big)`` steps of ``inner``
    calls each; the per-call time is sane on the CPU."""
    x = torch.ones((64, 64), dtype=torch.float32)
    carries = []

    def fn(a, c):
        carries.append(c)
        return torch.sum(a * (1.0 + c * 1e-20))

    per = harness.amortized_op_time(fn, (x,), n_small=5, n_big=50, reps=2, inner=inner)
    # CPU timing noise can make the two-point difference slightly negative
    # for a microsecond-scale op; only gross breakage is caught
    assert -0.01 <= per < 0.1
    assert len(carries) == (5 + 2 * (5 + 50)) * inner
    assert all(isinstance(c, torch.Tensor) and c.dim() == 0 and c.device == x.device
               for c in carries)


def test_wall_time_forces_completion():
    x = torch.ones((128, 128), dtype=torch.float32)
    t = harness.wall_time(lambda: float(torch.sum(x @ x)), reps=2)
    assert 0 < t < 5.0


def test_differenced_takes_the_unit_time_between_two_counts():
    """``differenced`` runs each count once to warm, then ``reps`` rounds of
    both, and returns (seconds a unit, seconds of the small run)."""
    import time

    calls = []

    def run(k):
        calls.append(k)
        time.sleep(0.01 * k)

    per, t_small = harness.differenced(run, 2, 6, reps=2)
    assert calls == [2, 6, 2, 6, 2, 6]
    assert 0.005 < per < 0.05 and 0.015 < t_small < 0.5


def test_loop_per_iter_runs_each_path_and_refuses_others():
    """The loop rows' and the headline's timer on CPU tensors (bcast/eigh):
    a time for the dense paths; an unknown path is refused."""
    ref, tr1 = (torch.as_tensor(a[::10], dtype=torch.float32) for a in harness.load_cow())
    for path in ("fused", "pipeline"):
        per, t_small = harness.loop_per_iter(ref, tr1, path, 1, 3, reps=1)
        assert np.isfinite(per) and 0 < t_small < 5.0
    with pytest.raises(ValueError, match="path must be one of"):
        harness.loop_per_iter(ref, tr1, "bf16", 1, 3, reps=1)


def test_matrix_rows_and_keys_match_jax():
    """The same rows under the same names with the same keys (times aside),
    and no utilization field off the accelerator in either package."""
    ours = harness.benchmark_matrix(n_iters=2, include=MATRIX_ROWS, device="cpu")
    theirs = j_harness.benchmark_matrix(n_iters=2, include=MATRIX_ROWS)
    assert [r["benchmark"] for r in ours] == [r["benchmark"] for r in theirs]
    for a, b in zip(ours, theirs):
        assert not any(k in a or k in b for k in UTILIZATION), (a, b)
        if not (a.get("unresolved") or b.get("unresolved")):
            assert set(a) == set(b), (a, b)
            assert a["time_us"] > 0


def test_matrix_runs_on_the_card_unless_asked(monkeypatch):
    """No card and no ``device``: the harness raises rather than moving to
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        harness.benchmark_matrix(include=["compute_centroid"])


def test_fused_path_disabled_takes_the_pipeline(monkeypatch):
    """The pipeline row's switch: the dense loop with ``pallas`` and
    ``qcp_fused`` runs K3's step each iteration, and under
    ``fused_path_disabled`` K2's step instead and no K3, the gate restored
    on exit, also after an exception (counted on the engine's own names:
    the CPU's plain versions count no launches)."""
    import icp_tpu_torch.engine.icp as engine
    from icp_tpu_torch.engine.icp import icp_fixed_iters

    calls = {"fused": 0, "step": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(engine, "fused_icp_step", counting("fused", engine.fused_icp_step))
    monkeypatch.setattr(engine, "qcp_step", counting("step", engine.qcp_step))
    ref, tr1 = cow_pair(10)
    kw = dict(n_iters=3, solver="qcp_fused", nn_method="pallas", device="cpu")
    fused = icp_fixed_iters(ref, tr1, **kw)
    assert calls == {"fused": 3, "step": 0}
    gate = engine.fused_path_available
    with harness.fused_path_disabled():
        pipe = icp_fixed_iters(ref, tr1, **kw)
    assert calls == {"fused": 3, "step": 3}
    assert engine.fused_path_available is gate
    with pytest.raises(ZeroDivisionError), harness.fused_path_disabled():
        1 / 0
    assert engine.fused_path_available is gate
    np.testing.assert_allclose(pipe.points.numpy(), fused.points.numpy(), atol=1e-5)


def test_run_cell_matches_jax(bench_ranks):
    """The weak-scaling cell on a gloo group of 1 and 2 ranks: JAX's cell on
    as many CPU devices, its error within rtol 1e-5 (the port sums the Horn
    statistics in float64, JAX in float32); every rank alike."""
    world = len(bench_ranks)
    got = bench_ranks[0]["cell"]
    for rank in bench_ranks[1:]:
        for k, v in got.items():
            np.testing.assert_array_equal(rank["cell"][k], v, err_msg=k)
    want = j_scaling.run_cell(world, 64, 2, True, model_points=128, reps=1)
    assert int(got["devices"]) == want["devices"] == world
    assert int(got["points"]) == want["points"] and int(got["iters"]) == want["iters"]
    assert np.isfinite(float(got["err"]))
    np.testing.assert_allclose(float(got["err"]), want["err"], rtol=1e-5, atol=1e-12)


def test_run_cell_refuses_a_size_the_group_lacks(bench_ranks):
    world = len(bench_ranks)
    assert (f"has {world} ranks, not {world + 1}"
            in str(bench_ranks[0]["refusals"]["size"]))


def test_icp_sharded_runs_past_max_iter_as_jax(bench_ranks):
    """Repair: ``n_iters`` above ``config.max_iter`` (the harness's sharded
    row: max_iter 1, n_iters 20 and 520) ran off the end of the error
    buffer; JAX's engine takes any bound.  Held to JAX's run on as many
    devices."""
    world = len(bench_ranks)
    got = bench_ranks[0]["over_max_iter"]
    ref, tr1 = cow_pair(20)
    cfg = icp_tpu.ICPConfig(max_iter=1, dtype=jnp.float64, solver="eigh", nn_method="bcast")
    want = j_icp_sharded(ref, tr1, cfg, mesh=j_make_mesh(jax.devices()[:world]), n_iters=5)
    assert int(got["iters"]) == int(want.iters) > 1
    np.testing.assert_allclose(float(got["err"]), float(want.err), rtol=1e-9)
    np.testing.assert_allclose(got["points"], np.asarray(want.points), rtol=0, atol=1e-9)


def test_chip_smoke_holds_the_bench_launches_against_plain(monkeypatch):
    """``chip_smoke.py``'s bench phase records each held wrapper's first call
    at each shape and holds it against the plain version; on CPU tensors
    K2, K4, K5 and K6 reach their wrappers, and K1's records (single and
    with the pair axis, on sampled rows) are built from its plain version.
    The names are put back; a changed index is caught."""
    import chip_smoke
    import icp_tpu_torch.engine.icp as engine
    from icp_tpu_torch.kernels import knn_dense, nn_dense
    from icp_tpu_torch.ops.alignment import alignment_from_stats, compute_alignment_stats

    ref, tr1 = cow_pair(4)
    ref, tr1 = (torch.as_tensor(a, dtype=torch.float32) for a in (ref, tr1))
    records, step = {}, engine.qcp_step
    with chip_smoke._recording_launches(records):
        assert engine.qcp_step is not step
        with harness.fused_path_disabled():
            engine.icp_fixed_iters(ref, tr1, n_iters=3, solver="qcp_fused", nn_method="pallas")
        engine.icp_fixed_iters(ref, tr1, n_iters=3, solver="qcp_fused", nn_method="grid")
        alignment_from_stats(compute_alignment_stats(tr1, ref), solver="qcp_fused")
        knn_dense.knn_dense(ref, ref, 5)
    assert engine.qcp_step is step
    assert {k[0] for k in records} == {"qcp_step", "nn_grid", "qcp_rotation_from", "knn_dense"}
    monkeypatch.setattr(chip_smoke, "BENCH_HELD_PAIRS", 300 * 726 - 1)
    monkeypatch.setattr(chip_smoke, "BENCH_HELD_ROWS", 64)
    s, m = tr1[:300].contiguous(), ref.contiguous()
    single = dict(scene=s, model=m, pairs=1, with_dist=True, distance_impl="vpu")
    records[("_launch", 1)] = (single, nn_dense.nn_dense_plain(s, m, with_dist=True), None)
    scenes, models = torch.stack([s, s + 0.01]), torch.stack([m, m])
    pair = dict(scene=scenes, model=models, pairs=2, with_dist=False, distance_impl="vpu")
    idx = nn_dense.nn_dense_batched_plain(scenes, models)
    records[("_launch", 2)] = (pair, idx, None)
    held = chip_smoke._hold_recorded(records, 0)
    assert len(held) == 6 and all(h["bit_equal_plain"] for h in held)
    # every pair (300 x 726) above the limit: 64 sampled rows of each
    assert [h["rows_held"] for h in held if h["kernel"] == "nn_dense"] == [64, 128]
    bad = idx.clone()
    bad[1, 7] += 1
    with pytest.raises(chip_smoke.SmokeError, match="pair 1"):
        chip_smoke._hold_recorded({("_launch", 2): (pair, bad, None)}, 0)
