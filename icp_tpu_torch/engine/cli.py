"""Command-line interface of the port (mirror of ``icp_tpu/engine/cli.py``).

Reference surface (``src/main.cc:6-25``):
  ``icp-torch [path_to_ref_cloud] [path_to_transform_cloud] [nb_iter]``
  * missing args  -> usage on stdout, exit status of ``return -1`` (255)
  * unopenable file -> ``[load] ...`` on stderr, exit 2
  * per-iteration  ``[ICP] iteration number i | error value = e`` on stderr
  * result cloud -> ``output.txt`` (+ ``[output] ...`` notice on stderr)

``--device {cuda,cpu}`` (default ``cuda``) picks where the run happens;
``cuda`` on a machine without a CUDA device exits with -1 — the CLI never
moves to the CPU on its own.  ``--engine point_to_plane``, ``symmetric``
and ``gicp`` run ``icp_point_to_plane``, ``icp_symmetric`` and
``icp_generalized`` with the same stderr trace and ``output.txt``
(``icp_tpu/engine/cli.py:180-191``).  The JAX CLI's flags are all accepted;
those not ported yet (``--sharded``, ``--checkpoint*``, ``--resume``,
``--metrics*``, ``--trim`` > 0) exit -1 with a one-line message.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from icp_tpu_torch.utils.precision import in_full_float32


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="icp-torch",
        usage="icp-torch [path_to_ref_cloud] [path_to_transform_cloud] [nb_iter]",
        description="ICP point-cloud registration (PyTorch/CUDA)",
    )
    p.add_argument("ref", help="reference (model) cloud CSV")
    p.add_argument("scene", help="cloud to transform CSV")
    p.add_argument("nb_iter", type=int, help="max iterations")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--threshold", type=float, default=1e-5)
    p.add_argument("--solver", default="auto",
                   choices=["auto", "eigh", "qcp", "qcp_fused", "kabsch"])
    p.add_argument("--nn", default="auto",
                   choices=["auto", "bcast", "matmul", "pallas", "grid"])
    p.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    p.add_argument("--no-scale", action="store_true", help="rigid (SE3) alignment")
    p.add_argument("--trim", type=float, default=0.0, metavar="FRAC")
    p.add_argument("--no-validate", action="store_true",
                   help="lift the np==nm reference restriction")
    p.add_argument("--mse", action="store_true",
                   help="report plain MSE instead of the reference's 2x metric")
    p.add_argument("--output", default="output.txt")
    p.add_argument("--engine", default="point_to_point",
                   choices=["point_to_point", "point_to_plane", "gicp",
                            "symmetric"])
    p.add_argument("--sharded", action="store_true")
    p.add_argument("--checkpoint", default=None, metavar="PATH")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="K")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--metrics", default=None, metavar="PATH")
    p.add_argument("--metrics-ops", action="store_true")
    return p


def _not_ported(args) -> str | None:
    flags = [
        (args.sharded, "--sharded"),
        (args.checkpoint is not None, "--checkpoint"),
        (bool(args.checkpoint_every), "--checkpoint-every"),
        (args.resume, "--resume"),
        (args.metrics is not None, "--metrics"),
        (args.metrics_ops, "--metrics-ops"),
        (args.trim > 0.0, "--trim"),
    ]
    return next((name for on, name in flags if on), None)


@in_full_float32
def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        # Reference parity: usage on STDOUT, return -1 (src/main.cc:8-12).
        print("Usage: icp-torch [path_to_ref_cloud] [path_to_transform_cloud] [nb_iter]")
        return -1
    args = build_parser().parse_args(argv)
    flag = _not_ported(args)
    if flag:
        print(f"{flag} is not ported yet to icp_tpu_torch", file=sys.stderr)
        return -1

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("[error] --device cuda: no CUDA device is available", file=sys.stderr)
        return -1

    from icp_tpu_torch.config import ICPConfig
    from icp_tpu_torch.engine.icp import icp
    from icp_tpu_torch.io.csv import load_matrix, write_matrix

    model = load_matrix(args.ref)
    scene = load_matrix(args.scene)
    cfg = ICPConfig(
        max_iter=args.nb_iter,
        threshold=args.threshold,
        dtype=torch.float64 if args.dtype == "float64" else torch.float32,
        solver=args.solver,
        nn_method=args.nn,
        with_scale=not args.no_scale,
        validate_inputs=not args.no_validate,
        reference_compat=not args.mse,
    )
    try:
        if args.engine == "point_to_plane":
            from icp_tpu_torch.engine.point_to_plane import icp_point_to_plane as run
        elif args.engine == "gicp":
            from icp_tpu_torch.engine.gicp import icp_generalized as run
        elif args.engine == "symmetric":
            from icp_tpu_torch.engine.symmetric import icp_symmetric as run
        else:
            run = icp
        tr = run(model, scene, cfg, trace=True, device=args.device)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return -1
    iters = int(tr.result.iters)
    # Reference's per-iteration stderr log (src/cpu.cc:61,74).
    for i, e in enumerate(tr.errs[:iters].cpu().numpy()):
        print(f"[ICP] iteration number {i} | error value = {e:g}", file=sys.stderr)
    write_matrix(np.asarray(tr.result.points.cpu()), args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
