"""The readings that the limits of ``correct`` are set from, at a cell's
own size, several seeds in one process:

* ``--mode control``: the reference put in the program's place and
  computed one precision below what the configuration states (TF32 for
  the port's float32 with TF32 off; ``reference/icp.py``,
  ``precision="tf32"``), on the cell's first requests, held to
  the same numbers as a run's sample.  A limit is sound only if the
  control's readings fail it;
* ``--mode program``: whole runs of the cell (``run.run_cell``) of
  ``--seconds`` each, the program's readings beside its limits;
* ``--mode fault --fault <name>``: the same with a fault of ``faults.py``
  planted under the program's entry; each has to fail a limit.

    python3 -m regbench.control --workload <cell> --seeds <n,n,...> [--mode ...]

One JSON line a seed.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from regbench import check, faults, run
from regbench.traffic import Generator


def readings(cell, seed: int, device: str, requests: int | None = None) -> dict:
    """The largest of each number over the control's answers to the
    cell's first ``requests`` requests (default: the cell's sample size,
    and 2 at least, so that both of the source's motions are in it)."""
    import torch

    gen = Generator(cell.config, cell.mix, seed, torch.device(device), cell.source)
    worst = {k: 0.0 for k in check.NUMBERS}
    for i in range(max(2, int(cell.limits["sample"])) if requests is None else requests):
        req = gen.make(i)
        model = req.model.double().cpu().numpy()
        scene = req.scene.double().cpu().numpy()
        diag = float(np.linalg.norm(model.max(0) - model.min(0)))
        ref = check.reference_answer(cell.config, cell.mix, model, scene, device=device)
        low = check.reference_answer(cell.config, cell.mix, model, scene, precision="tf32",
                                     device=device)
        ref = check.reference_for(low, ref, cell.config, cell.mix, model, scene, device)
        for k, v in check.gaps(low, ref, scene, diag).items():
            worst[k] = max(worst[k], v)
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m regbench.control",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--mode", choices=("control", "program", "fault"), default="control")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = run.load_cell(args.workload)
    limits = {k: cell.limits.get(k) for k in check.NUMBERS}
    undo = faults.install(args.fault, cell.mix["entry"]) if args.mode == "fault" else None
    for seed in (int(s) for s in args.seeds.split(",")):
        line = {"workload": args.workload, "mode": args.mode, "fault": args.fault, "seed": seed}
        if args.mode == "control":
            got = readings(cell, seed, args.device)
            line.update(readings=got, limits=limits, failed=check.fails(got, limits))
        else:
            out = run.run_cell(cell, seed, args.seconds, False, args.device)
            got = out["notes"]["readings"]
            line.update(readings=got, limits=limits, correct=out["correct"],
                        failed_registrations=out["failed"], notes=out["notes"],
                        metrics={k: v["value"] for k, v in out["metrics"].items()})
        print(json.dumps(line), flush=True)
    if undo is not None:
        undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
