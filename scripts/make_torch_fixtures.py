#!/usr/bin/env python3
"""Regenerate the JAX fixtures that the PyTorch port's runs are held
against (``tests/fixtures/torch_p2pl/``, ``torch_sym/``, ``torch_gicp/``,
``torch_trim/``, ``torch_flags/``, ``torch_slam/`` and ``torch_slam_grid/``).

    JAX_PLATFORMS=cpu python3 scripts/make_torch_fixtures.py [FOLDER ...]

Runs the JAX package's CLI (``python -m icp_tpu.engine.cli``) on the CPU
with 30 iterations on the bundled cow pairs, from the repository root and
with relative paths, and keeps each run's stderr trace and ``output.txt``:
``--engine point_to_plane``, ``symmetric`` and ``gicp`` into their folders,
and every engine with ``--trim 0.1`` into ``torch_trim/`` (files
``{engine}_{pair}_*``; point-to-point with ``--dtype float64``).  ``torch_slam/``:
the JAX ``icp-slam`` CLI (``python -m icp_tpu.slam.cli``) on the five bunny
scans with ``SLAM_FLAGS`` (about a minute on the CPU), its ``poses.npz``,
its ``[slam]`` stderr lines (each pair's iterations and error, the
closure candidates, the pose graph's cost) and a README with the command
and the run's wall seconds.  ``torch_slam_grid/``: the same CLI on the
grid path (``SLAM_GRID_FLAGS``: ``--subsample 4 --nn grid``, a few minutes
on the CPU, where the grid kernels run in Pallas interpret mode).
``torch_flags/``: point-to-point on cow at ``FLAG_NB_ITER`` iterations with
each of the CLI's other flags (``FLAG_RUNS``: ``--no-scale``, ``--mse``,
``--dtype float64``, ``--threshold``, ``--solver``, ``--nn``), files
``{case}_stderr.txt`` and ``{case}_output.txt``; the JAX CLI has no
``--nn bf16``, so that case runs ``BF16_RUN``, JAX's ``icp(...,
trace=True)`` with the CLI's loads, trace lines and output.
With folder names, only those are rewritten.  The
JAX package is imported only by the subprocess; the port and
``chip_smoke.py`` read the files.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
# (engine, folder, extra flags, file prefix)
RUNS = [("point_to_plane", "torch_p2pl", [], ""), ("symmetric", "torch_sym", [], ""),
        ("gicp", "torch_gicp", [], "")]
# point-to-point in float64: its float32 eigh sums flip trim decisions from
# cow_tr1's iteration 3 (tests/fixtures/torch_trim/README.md)
RUNS += [(engine, "torch_trim",
          ["--trim", "0.1"] + (["--dtype", "float64"] if engine == "point_to_point" else []),
          f"{engine}_") for engine in ("point_to_point", "point_to_plane", "symmetric", "gicp")]
# torch_flags: case -> (scene, flags); cow_ref.txt is the model of every case
FLAG_RUNS = {
    "no_scale": ("cow_tr1.txt", ["--no-scale"]),
    "mse": ("cow_tr1.txt", ["--mse"]),
    "float64": ("cow_tr1.txt", ["--dtype", "float64"]),
    "threshold_1e-3": ("cow_tr1.txt", ["--threshold", "1e-3"]),
    "solver_eigh": ("cow_tr1.txt", ["--solver", "eigh"]),
    "solver_qcp": ("cow_tr1.txt", ["--solver", "qcp"]),
    "solver_kabsch": ("cow_tr1.txt", ["--solver", "kabsch"]),
    "nn_matmul": ("cow_tr1.txt", ["--nn", "matmul"]),
    "nn_grid": ("cow_tr1.txt", ["--nn", "grid"]),
    "nn_bf16": ("cow_tr1.txt", ["--nn", "bf16"]),
    "cow_tr2_no_scale_mse": ("cow_tr2.txt", ["--no-scale", "--mse"]),
}
FLAG_NB_ITER = "10"  # the reference fixtures' count
# JAX's CLI with --nn bf16, which its parser does not offer: the same
# loads, [ICP] lines and output.txt around icp(..., trace=True)
BF16_RUN = """import sys
import numpy as np
from icp_tpu import ICPConfig, icp
from icp_tpu.io.csv import load_matrix, write_matrix
model, scene = load_matrix(sys.argv[1]), load_matrix(sys.argv[2])
tr = icp(model, scene, ICPConfig(max_iter=int(sys.argv[3]), nn_method="bf16"), trace=True)
for i, e in enumerate(np.asarray(tr.errs)[:int(tr.result.iters)]):
    print(f"[ICP] iteration number {i} | error value = {e:g}", file=sys.stderr)
write_matrix(np.asarray(tr.result.points), sys.argv[4])
"""
FLAGS_README = """# torch_flags: the JAX CLI's point-to-point runs with its other flags

The stderr trace and `output.txt` of the JAX package's CLI on the CPU,
`data/cow_ref.txt` against a cow scene at `nb_iter` {nb_iter} (the reference
fixtures' count), one case a flag (`{{case}}_stderr.txt`,
`{{case}}_output.txt`). The port's CLI is held against them on the CPU
(`tests/test_torch_cli_flags.py`) and on the card (`chip_smoke.py`'s
`FLAG_CASES`, with `--device cuda`).

Made from the repository root by
`JAX_PLATFORMS=cpu python3 scripts/make_torch_fixtures.py torch_flags`
(the JAX package unchanged), which runs, keeping the program's own stderr
lines (`[load]`, `[ICP]`, `[output]`):

```bash
{commands}
```

JAX's CLI offers no `--nn bf16`, so `nn_bf16` runs `BF16_RUN` of the
script: JAX's `icp(..., ICPConfig(max_iter={nb_iter}, nn_method="bf16"),
trace=True)` between the CLI's `load_matrix` and `write_matrix`, printing
the CLI's `[ICP]` lines. The port runs it through `icp` too.

| case | iterations | last error |
|---|---|---|
{table}

On the CPU "auto" resolves to JAX's `bcast` NN and `eigh` solver, so these
are float32 runs (float64 for `float64`), each with the flag's own NN or
solver; `--nn grid` and `--nn bf16` run their Pallas kernels in interpret
mode.
"""
CASES = [("cow_tr1", "cow_ref.txt", "cow_tr1.txt"),
         ("cow_tr2", "cow_ref.txt", "cow_tr2.txt")]
NB_ITER = "30"
SLAM_SCANS = [os.path.join("data", f"bun{v}.txt") for v in ("000", "045", "180", "270", "315")]
SLAM_FLAGS = ["--subsample", "16", "--max-iter", "30", "--engine", "point_to_plane", "--init",
              "pca", "--trim", "0.3", "--multiscale", "4", "1", "--detect-closures"]
# --subsample 4 --nn grid: the grid path (K4 NN, K7 normals) at a size the
# JAX CPU run takes in minutes
SLAM_GRID_FLAGS = ["--subsample", "4", "--nn", "grid"] + SLAM_FLAGS[2:]
SLAM_README = """# {folder}: the JAX icp-slam CLI on the five bunny scans{what}

Made on the CPU by `scripts/make_torch_fixtures.py {folder}`, which runs,
from the repository root:

    JAX_PLATFORMS=cpu python -m icp_tpu.slam.cli {scans} {flags}

It took {seconds:.1f} s of wall time.

- `poses.npz`: the world poses (keys s, R, t) it saved;
- `stderr.txt`: its `[slam]` lines: each chain pair's iterations and
  trimmed error, the closure candidates, the chain edges it down-weighted
  and the pose graph's cost.

The port's `icp-slam-torch` is held to the same closure pairs, iterations
and poses within a tolerance ({held}): RANSAC draws its triplets from each
package's own generator.
{note}"""
SLAM_GRID_NOTE = """
`--subsample 4` (about 10,000 rows a scan): JAX's CPU run of it, its grid
kernels in Pallas interpret mode, takes minutes (above), so no coarser
subsample was needed.  Pairs 1->2,
2->3 and 3->4 end at the iteration cap (60 = 2 levels x 30) without
converging: their trimmed error oscillates from iteration to iteration
(1.36e-5 to 1.39e-5 at the fine level of 1->2), and a float32 rounding
difference is amplified along such a loop.  So the port's run agrees
with this one to the pose tolerance and each capped pair's error within
its band (`chip_smoke.py`, `_SLAM_FIXTURES`), not to the last digit.
"""
# folder -> (flags, title suffix, where the port is held to it, note)
SLAM_RUNS = {
    "torch_slam": (SLAM_FLAGS, "", "`tests/test_torch_slam_cli.py`,\n`chip_smoke.py`'s slam phase",
                   ""),
    "torch_slam_grid": (SLAM_GRID_FLAGS, " on the grid path",
                        "`chip_smoke.py`'s slam phase,\non the card", SLAM_GRID_NOTE),
}


def make_slam(env, folder: str) -> int:
    flags, what, held, note = SLAM_RUNS[folder]
    out_dir = os.path.join(FIXTURES, folder)
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "icp_tpu.slam.cli", *SLAM_SCANS, *flags,
               "--output-prefix", os.path.join(tmp, "registered_"),
               "--poses", os.path.join(tmp, "poses.npz")]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if r.returncode != 0:
            print(r.stderr, file=sys.stderr)
            return r.returncode
        lines = [ln for ln in r.stderr.splitlines()
                 if ln.startswith("[slam]") and "poses saved" not in ln]
        with open(os.path.join(out_dir, "stderr.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        shutil.copyfile(os.path.join(tmp, "poses.npz"), os.path.join(out_dir, "poses.npz"))
    with open(os.path.join(out_dir, "README.md"), "w") as f:
        f.write(SLAM_README.format(folder=folder, what=what, scans=" ".join(SLAM_SCANS),
                                   flags=" ".join(flags), seconds=seconds, held=held,
                                   note=note))
    print(f"{folder}: {len(lines)} [slam] lines, {seconds:.1f} s")
    return 0


def _flag_command(case: str, out_txt: str) -> list:
    """The command of a torch_flags case, from the repository root."""
    scene, flags = FLAG_RUNS[case]
    clouds = [os.path.join("data", "cow_ref.txt"), os.path.join("data", scene), FLAG_NB_ITER]
    if flags == ["--nn", "bf16"]:
        return [sys.executable, "-c", BF16_RUN, *clouds, out_txt]
    return [sys.executable, "-m", "icp_tpu.engine.cli", *clouds, *flags, "--output", out_txt]


def make_flags(env) -> int:
    out_dir = os.path.join(FIXTURES, "torch_flags")
    os.makedirs(out_dir, exist_ok=True)
    commands, rows = [], []
    for case, (scene, flags) in FLAG_RUNS.items():
        with tempfile.TemporaryDirectory() as tmp:
            out_txt = os.path.join(tmp, "output.txt")
            r = subprocess.run(_flag_command(case, out_txt), cwd=ROOT, env=env,
                               capture_output=True, text=True)
            if r.returncode != 0:
                print(r.stderr, file=sys.stderr)
                return r.returncode
            lines = [ln.replace(out_txt, "output.txt") for ln in r.stderr.splitlines()
                     if ln.startswith("[")]
            with open(os.path.join(out_dir, f"{case}_stderr.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
            shutil.copyfile(out_txt, os.path.join(out_dir, f"{case}_output.txt"))
        trace = [ln.rsplit("= ", 1)[1] for ln in lines if ln.startswith("[ICP]")]
        rows.append(f"| `{case}` | {len(trace)} | {trace[-1] if trace else '-'} |")
        if case != "nn_bf16":
            commands.append(f"JAX_PLATFORMS=cpu python -m icp_tpu.engine.cli data/cow_ref.txt "
                            f"data/{scene} {FLAG_NB_ITER} {' '.join(flags)}")
        print(f"torch_flags {case}: {len(trace)} iterations")
    with open(os.path.join(out_dir, "README.md"), "w") as f:
        f.write(FLAGS_README.format(nb_iter=FLAG_NB_ITER, commands="\n".join(commands),
                                    table="\n".join(rows)))
    return 0


def main(argv=None) -> int:
    only = set(sys.argv[1:] if argv is None else argv)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    if not only or "torch_flags" in only:
        code = make_flags(env)
        if code:
            return code
    for folder in SLAM_RUNS:
        if not only or folder in only:
            code = make_slam(env, folder)
            if code:
                return code
    for engine, folder, extra, prefix in RUNS:
        if only and folder not in only:
            continue
        out_dir = os.path.join(FIXTURES, folder)
        os.makedirs(out_dir, exist_ok=True)
        for name, ref, scene in CASES:
            with tempfile.TemporaryDirectory() as tmp:
                out_txt = os.path.join(tmp, "output.txt")
                cmd = [sys.executable, "-m", "icp_tpu.engine.cli",
                       os.path.join("data", ref), os.path.join("data", scene), NB_ITER,
                       "--engine", engine, "--output", out_txt, *extra]
                r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True)
                if r.returncode != 0:
                    print(r.stderr, file=sys.stderr)
                    return r.returncode
                # keep the program's own lines ([load], [ICP], [output]), not
                # the runtime's warnings
                lines = [ln for ln in r.stderr.splitlines() if ln.startswith("[")]
                lines = [ln.replace(out_txt, "output.txt") for ln in lines]
                with open(os.path.join(out_dir, f"{prefix}{name}_stderr.txt"), "w") as f:
                    f.write("\n".join(lines) + "\n")
                shutil.copyfile(out_txt, os.path.join(out_dir, f"{prefix}{name}_output.txt"))
            n_iter = sum(ln.startswith("[ICP]") for ln in lines)
            print(f"{folder} {engine} {' '.join(extra)} {name}: {n_iter} iterations")
    return 0


if __name__ == "__main__":
    sys.exit(main())
