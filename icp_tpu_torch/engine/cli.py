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
(``icp_tpu/engine/cli.py:180-191``).  The JAX CLI's flags and run modes
are all here (``icp_tpu/engine/cli.py:116-133``): ``--trim``;
``--checkpoint PATH`` (a plain run saves its result there), with
``--checkpoint-every K`` and ``--resume`` the chunked ``icp_resumable``;
``--metrics PATH`` (``run_with_metrics``'s JSON record, with
``--metrics-ops`` the op times); ``--sharded``, the engine's sharded form
(``parallel/sharded.py``) over every rank of the process group: under
``torchrun`` its group (rank 0 alone prints the trace and writes
``output.txt`` and the checkpoint), otherwise this process alone at world
size 1.  The run modes exclude each other and the plane engines take only
the plain and ``--sharded`` ones.
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
    p.add_argument("--trim", type=float, default=0.0, metavar="FRAC",
                   help="trimmed ICP: reject this fraction of worst matches")
    p.add_argument("--no-validate", action="store_true",
                   help="lift the np==nm reference restriction")
    p.add_argument("--mse", action="store_true",
                   help="report plain MSE instead of the reference's 2x metric")
    p.add_argument("--output", default="output.txt")
    p.add_argument("--engine", default="point_to_point",
                   choices=["point_to_point", "point_to_plane", "gicp",
                            "symmetric"])
    p.add_argument("--sharded", action="store_true",
                   help="split the points over the ranks of the process group (torchrun), "
                        "or run the sharded engine at world size 1")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="save transform state (s, R, t, iter, err) as npz")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="K",
                   help="save the checkpoint every K iterations (runs the loop in "
                        "K-iteration chunks; requires --checkpoint)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the --checkpoint file if it exists "
                        "(bit-for-bit continuation of a killed run)")
    p.add_argument("--metrics", default=None, metavar="PATH",
                   help="write a JSON run record (per-iteration error trace, iters, "
                        "wall time, device and op config)")
    p.add_argument("--metrics-ops", action="store_true",
                   help="with --metrics: also time the correspondence and alignment "
                        "ops (CUDA events on the card)")
    return p


def _run_mode_error(args) -> str | None:
    """JAX's rules for the run-mode flags (``icp_tpu/engine/cli.py:116-133``),
    or None when the combination is allowed."""
    if (args.checkpoint_every or args.resume) and not args.checkpoint:
        return "--checkpoint-every/--resume require --checkpoint PATH"
    modes = [m for m, on in (("--checkpoint-every/--resume",
                              args.checkpoint_every or args.resume),
                             ("--sharded", args.sharded),
                             ("--metrics", bool(args.metrics))) if on]
    if len(modes) > 1:
        return f"{' and '.join(modes)} cannot be combined"
    if args.engine != "point_to_point" and (args.checkpoint_every or args.resume
                                            or args.metrics):
        return (f"--engine {args.engine} supports only the plain and "
                "--sharded run modes")
    return None


def _run_sharded(engine: str, model, scene, cfg, device: str):
    """(result, its error trace, this rank) of the engine's sharded form on
    a mesh over the process group: ``torchrun``'s, or a world-1 group made
    here and taken down after the run."""
    import torch.distributed as dist

    from icp_tpu_torch.engine.gicp import icp_generalized_sharded
    from icp_tpu_torch.engine.point_to_plane import icp_point_to_plane_sharded
    from icp_tpu_torch.engine.symmetric import icp_symmetric_sharded
    from icp_tpu_torch.parallel.mesh import make_mesh
    from icp_tpu_torch.parallel.sharded import icp_sharded

    run = {"point_to_point": icp_sharded, "point_to_plane": icp_point_to_plane_sharded,
           "symmetric": icp_symmetric_sharded, "gicp": icp_generalized_sharded}[engine]
    own_group = not dist.is_initialized()
    mesh = make_mesh(device)
    try:
        tr = run(model, scene, cfg, mesh=mesh, trace=True)
        rank = dist.get_rank()
    finally:
        if own_group:
            dist.destroy_process_group()
    iters = int(tr.result.iters)
    return tr.result, tr.errs[:iters].cpu().numpy(), rank


@in_full_float32
def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        # Reference parity: usage on STDOUT, return -1 (src/main.cc:8-12).
        print("Usage: icp-torch [path_to_ref_cloud] [path_to_transform_cloud] [nb_iter]")
        return -1
    args = build_parser().parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("[error] --device cuda: no CUDA device is available", file=sys.stderr)
        return -1

    from icp_tpu_torch.config import ICPConfig
    from icp_tpu_torch.engine.plane import run_engine
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
        trim_fraction=args.trim,
    )
    # after the loads, as JAX's CLI: an unopenable file exits 2 first
    refused = _run_mode_error(args)
    if refused:
        print(refused, file=sys.stderr)
        return -1
    errs = None
    rank = 0
    try:
        if args.sharded:
            res, errs, rank = _run_sharded(args.engine, model, scene, cfg, args.device)
            iters = int(res.iters)
        elif args.checkpoint_every or args.resume:
            from icp_tpu_torch.engine.icp import icp_resumable

            res = icp_resumable(model, scene, cfg, checkpoint_path=args.checkpoint,
                                checkpoint_every=args.checkpoint_every or 50,
                                resume=args.resume, device=args.device)
            iters = int(res.iters)
        elif args.metrics:
            from icp_tpu_torch.utils.metrics import run_with_metrics

            tr, rec = run_with_metrics(model, scene, cfg, measure_ops=args.metrics_ops,
                                       device=args.device)
            res, iters = tr.result, rec.iters
            errs = tr.errs[:iters].cpu().numpy()
            with open(args.metrics, "w") as f:
                f.write(rec.to_json() + "\n")
            print(f"[metrics] written to {args.metrics}", file=sys.stderr)
        else:
            tr = run_engine(args.engine, model, scene, cfg, trace=True, device=args.device)
            res, iters = tr.result, int(tr.result.iters)
            errs = tr.errs[:iters].cpu().numpy()
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return -1
    if rank != 0:
        return 0
    if errs is not None:
        # Reference's per-iteration stderr log (src/cpu.cc:61,74).
        for i, e in enumerate(errs):
            print(f"[ICP] iteration number {i} | error value = {e:g}", file=sys.stderr)
    else:
        print(f"[ICP] converged after {iters} iterations | "
              f"error value = {float(res.err):g}", file=sys.stderr)
    write_matrix(np.asarray(res.points.cpu()), args.output)
    if args.checkpoint:
        from icp_tpu_torch.utils.checkpoint import save_checkpoint

        save_checkpoint(args.checkpoint, transform=res.transform, iteration=iters,
                        err=float(res.err))
        print(f"[checkpoint] saved to {args.checkpoint}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
