#!/usr/bin/env python3
"""Regenerate the JAX fixtures that the PyTorch port's runs are held
against (``tests/fixtures/torch_p2pl/``, ``torch_sym/``, ``torch_gicp/``
and ``torch_trim/``).

    JAX_PLATFORMS=cpu python3 scripts/make_torch_fixtures.py [FOLDER ...]

Runs the JAX package's CLI (``python -m icp_tpu.engine.cli``) on the CPU
with 30 iterations on the bundled cow pairs, from the repository root and
with relative paths, and keeps each run's stderr trace and ``output.txt``:
``--engine point_to_plane``, ``symmetric`` and ``gicp`` into their folders,
and every engine with ``--trim 0.1`` into ``torch_trim/`` (files
``{engine}_{pair}_*``; point-to-point with ``--dtype float64``).  With folder names, only those are rewritten.  The
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


def main(argv=None) -> int:
    only = set(sys.argv[1:] if argv is None else argv)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
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
