#!/usr/bin/env python3
"""Regenerate the JAX fixtures that the PyTorch port's runs are held
against (``tests/fixtures/torch_p2pl/``, ``torch_sym/``, ``torch_gicp/``,
``torch_trim/`` and ``torch_slam/``).

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
closure candidates, the pose graph's cost) and a README with the command.
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
CASES = [("cow_tr1", "cow_ref.txt", "cow_tr1.txt"),
         ("cow_tr2", "cow_ref.txt", "cow_tr2.txt")]
NB_ITER = "30"
SLAM_SCANS = [os.path.join("data", f"bun{v}.txt") for v in ("000", "045", "180", "270", "315")]
SLAM_FLAGS = ["--subsample", "16", "--max-iter", "30", "--engine", "point_to_plane", "--init",
              "pca", "--trim", "0.3", "--multiscale", "4", "1", "--detect-closures"]
SLAM_README = """# torch_slam: the JAX icp-slam CLI on the five bunny scans

Made on the CPU by `scripts/make_torch_fixtures.py torch_slam`, which runs,
from the repository root:

    JAX_PLATFORMS=cpu python -m icp_tpu.slam.cli {scans} {flags}

- `poses.npz`: the world poses (keys s, R, t) it saved;
- `stderr.txt`: its `[slam]` lines: each chain pair's iterations and
  trimmed error, the closure candidates, the chain edges it down-weighted
  and the pose graph's cost.

The port's `icp-slam-torch` is held to the same closure pairs, iterations
and poses within a tolerance (`tests/test_torch_slam_cli.py`,
`chip_smoke.py`'s slam phase): RANSAC draws its triplets from each
package's own generator.
"""


def make_slam(env) -> int:
    out_dir = os.path.join(FIXTURES, "torch_slam")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "icp_tpu.slam.cli", *SLAM_SCANS, *SLAM_FLAGS,
               "--output-prefix", os.path.join(tmp, "registered_"),
               "--poses", os.path.join(tmp, "poses.npz")]
        r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stderr, file=sys.stderr)
            return r.returncode
        lines = [ln for ln in r.stderr.splitlines()
                 if ln.startswith("[slam]") and "poses saved" not in ln]
        with open(os.path.join(out_dir, "stderr.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        shutil.copyfile(os.path.join(tmp, "poses.npz"), os.path.join(out_dir, "poses.npz"))
    with open(os.path.join(out_dir, "README.md"), "w") as f:
        f.write(SLAM_README.format(scans=" ".join(SLAM_SCANS), flags=" ".join(SLAM_FLAGS)))
    print(f"torch_slam: {len(lines)} [slam] lines")
    return 0


def main(argv=None) -> int:
    only = set(sys.argv[1:] if argv is None else argv)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    if not only or "torch_slam" in only:
        code = make_slam(env)
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
