"""The port's CLI with the JAX CLI's other flags, on the CPU, and two CLI
repairs.

Each ``chip_smoke.FLAG_CASES`` case (``--no-scale``, ``--mse``, ``--dtype
float64``, ``--threshold``, ``--solver``, ``--nn``) runs in-process with
``--device cpu`` against the JAX CLI's run (``tests/fixtures/torch_flags/``,
``scripts/make_torch_fixtures.py torch_flags``), with the case's tolerances:
once as the CPU resolves "auto" (bcast, eigh) and once as the card does at
cow's size (pallas, qcp_fused), where the plain versions of the card's
kernels (K3, K1 + the torch solver, K5, K4 + K2, K9) take the card's path.

C1: a refused run-mode combination is refused after the clouds are
loaded, so an unopenable file exits 2 first, as in JAX's CLI.  C2: a
negative ``nb_iter`` runs no iteration and writes the scene, as the
reference binary's loop (JAX's CLI raises on 0 and below).
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

import chip_smoke
from icp_tpu.engine.cli import main as jax_main
from icp_tpu_torch import ICPConfig, icp, icp_batched
from icp_tpu_torch.engine.cli import main
from icp_tpu_torch.engine.plane import run_engine
from icp_tpu_torch.io.csv import load_matrix
from tests.conftest import data_path

FIXDIR = os.path.join(chip_smoke.FIXTURES, "torch_flags")


@pytest.fixture(scope="module")
def cow():
    with contextlib.redirect_stderr(io.StringIO()):
        return {name: load_matrix(data_path(f"{name}.txt"))
                for name in ("cow_ref", "cow_tr1", "cow_tr2")}


def _load_lines(text: str) -> list:
    return [ln for ln in text.splitlines() if ln.startswith("[load]")]


def _card_resolution(flags: list) -> list:
    """The flags with "auto" resolved as the card resolves it at cow's size
    (below ``GRID_AUTO_THRESHOLD``: the dense kernel and ``qcp_fused``)."""
    extra = [] if "--nn" in flags else ["--nn", "pallas"]
    return extra + ([] if "--solver" in flags else ["--solver", "qcp_fused"])


@pytest.mark.parametrize("resolution", ["cpu_auto", "card_auto"])
@pytest.mark.parametrize("case", list(chip_smoke.FLAG_CASES))
def test_flag_case_against_jax_cli(case, resolution, tmp_path, monkeypatch):
    monkeypatch.chdir(chip_smoke.ROOT)  # relative paths, as in the fixture's [load] lines
    out = str(tmp_path / "output.txt")
    args = chip_smoke.flag_case_args(case, out, root="")
    if resolution == "card_auto":
        args += _card_resolution(chip_smoke.FLAG_CASES[case][1])
    rc, got, err, _, used = chip_smoke._run_cli(args, device="cpu")
    chip_smoke.hold_flag_case(case, rc, got, err, out)
    with open(os.path.join(FIXDIR, f"{case}_stderr.txt")) as f:
        assert _load_lines(err) == _load_lines(f.read())
    assert not any(used.values())  # the plain versions: no kernel on CPU tensors


@pytest.mark.parametrize("flags,msg", [
    (["--sharded", "--metrics", "m.json"], "--sharded and --metrics cannot be combined"),
    (["--resume"], "--checkpoint-every/--resume require --checkpoint PATH"),
    (["--engine", "gicp", "--checkpoint-every", "2"],
     "--checkpoint-every/--resume require --checkpoint PATH"),
])
def test_run_mode_refused_after_the_loads_as_jax(flags, msg, tmp_path, monkeypatch):
    """C1: with an unopenable scene both CLIs exit 2 with the same four
    ``[load]`` lines; with readable clouds both refuse with the same
    message, after the loads, and write nothing."""
    monkeypatch.chdir(tmp_path)
    for scene in ("nope.txt", data_path("cow_tr1.txt")):
        runs = []
        for entry, extra in ((main, ["--device", "cpu"]), (jax_main, [])):
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                try:
                    rc = entry([data_path("cow_ref.txt"), scene, "5", *extra, *flags])
                except SystemExit as e:
                    rc = e.code
            runs.append((rc, err.getvalue().splitlines()))
        (rc, lines), (jax_rc, jax_lines) = runs
        assert (rc, lines) == (jax_rc, jax_lines)
        if scene == "nope.txt":
            assert rc == 2 and lines[-1] == "[load] nope.txt could not be opened"
            assert len(lines) == 4 and msg not in "\n".join(lines)
        else:
            assert rc == -1 and lines[-1] == msg and len(_load_lines("\n".join(lines))) == 4
    assert not list(tmp_path.iterdir())


def test_negative_nb_iter_writes_the_scene(tmp_path):
    """C2: ``nb_iter`` -3 exits 0, prints no iteration and writes the
    same ``output.txt`` as 0: the scene, unmoved."""
    outs = {}
    for n in ("0", "-3"):
        out = tmp_path / f"out_{n}.txt"
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = main([data_path("cow_ref.txt"), data_path("cow_tr1.txt"), n, "--device", "cpu",
                       "--output", str(out)])
        assert rc == 0 and "[ICP]" not in err.getvalue()
        outs[n] = out.read_bytes()
    assert outs["-3"] == outs["0"]
    with contextlib.redirect_stderr(io.StringIO()):
        np.testing.assert_array_equal(load_matrix(str(tmp_path / "out_-3.txt")),
                                      load_matrix(data_path("cow_tr1.txt")))


@pytest.mark.parametrize("engine,nn,solver", [
    ("point_to_point", "bcast", "eigh"), ("point_to_point", "pallas", "qcp_fused"),
    ("point_to_point", "matmul", "qcp_fused"), ("point_to_point", "grid", "qcp_fused"),
    ("point_to_point", "grid", "eigh"), ("point_to_plane", "auto", "auto"),
])
def test_negative_max_iter_runs_no_iteration(cow, engine, nn, solver):
    """C2 in each loop that sizes its buffers from the count: the dense
    paths (K3's, K5's, the plain solver's), the grid loop and a plane
    engine's."""
    cfg = ICPConfig(max_iter=-3, nn_method=nn, solver=solver)
    scene = cow["cow_tr1"][:500]
    tr = run_engine(engine, cow["cow_ref"][:500], scene, cfg, trace=True, device="cpu")
    assert int(tr.result.iters) == 0 and tr.errs.shape == (0,)
    assert float(tr.result.err) == float("inf")
    np.testing.assert_array_equal(tr.result.points.numpy(), scene.astype(np.float32))


@pytest.mark.parametrize("nn,solver", [("bcast", "eigh"), ("pallas", "qcp_fused"),
                                       ("grid", "qcp_fused")])
def test_batched_negative_n_iters_runs_no_iteration(cow, nn, solver):
    """C2 in ``icp_batched``: the pair-axis kernel path, the bcast path and
    the pair-by-pair grid path."""
    scenes = np.stack([cow["cow_tr1"][:400], cow["cow_tr2"][:400]])
    models = np.stack([cow["cow_ref"][:400]] * 2)
    res = icp_batched(models, scenes, n_iters=-3, nn_method=nn, solver=solver, device="cpu")
    assert res.iters.tolist() == [0, 0]
    assert torch.isinf(res.err).all()
    np.testing.assert_array_equal(res.points.numpy(), scenes.astype(np.float32))
