"""Multi-scan registration CLI of the port (mirror of
``icp_tpu/slam/cli.py``): ``icp-slam-torch scan0.txt scan1.txt ...``

Registers each scan onto its predecessor (unequal point counts allowed),
composes world poses, optionally detects, refines and optimises loop
closures and bundle-adjusts the poses, and writes every scan moved into
scan 0's frame (``{prefix}{k}.txt``) and the poses (``--poses``, npz keys
s, R, t), with the JAX CLI's flags and stderr lines, and one line more a
closure edge: how far the transform of scan j into scan i that the poses
give is from the edge (the largest entry of each difference, rotation and
translation), before and after the pose graph.  ``--device {cuda,cpu}``
(default ``cuda``) picks where the run happens; ``cuda`` without a CUDA
device exits -1 and never moves to the CPU on its own.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from icp_tpu_torch.utils.precision import in_full_float32


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="icp-slam-torch",
                                description="multi-scan registration (PyTorch/CUDA)")
    p.add_argument("clouds", nargs="+", help="scan CSVs, in chain order")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--max-iter", type=int, default=60)
    p.add_argument("--threshold", type=float, default=1e-5)
    p.add_argument("--subsample", type=int, default=1,
                   help="use every k-th point for registration (outputs are full)")
    p.add_argument("--voxel", type=float, default=0.0, metavar="SIZE",
                   help="voxel-grid downsample each scan for registration (after "
                        "--subsample; outputs are full)")
    p.add_argument("--multiscale", type=int, nargs="*", default=[1],
                   help="coarse-to-fine subsampling levels, e.g. 16 4 1")
    p.add_argument("--init", default=None, choices=[None, "pca", "fpfh"],
                   help="per-pair global initialisation: principal axes, or FPFH "
                        "features + RANSAC")
    p.add_argument("--scale", action="store_true",
                   help="similarity (per-pair scale); default rigid")
    p.add_argument("--engine", default="point_to_point",
                   choices=["point_to_point", "point_to_plane", "gicp", "symmetric"])
    p.add_argument("--trim", type=float, default=0.0, metavar="FRAC",
                   help="trimmed registration: reject this fraction of worst matches")
    p.add_argument("--bucket", type=int, default=-1, metavar="QUANTUM",
                   help="pad each pair's clouds to the next QUANTUM multiple (true counts "
                        "masked); -1 = auto (on for unequal-count chains on the CPU, "
                        "off on the card), 0 = off")
    p.add_argument("--refine", action="store_true", help="bundle-adjust poses after the chain")
    p.add_argument("--detect-closures", action="store_true",
                   help="detect overlapping non-adjacent scan pairs (FPFH + RANSAC), "
                        "refine them with ICP and optimise the pose graph")
    p.add_argument("--closure-min-inliers", type=float, default=0.15, metavar="FRAC",
                   help="RANSAC inlier fraction required to accept a closure candidate")
    p.add_argument("--solver", default="auto")
    p.add_argument("--nn", default="auto")
    p.add_argument("--output-prefix", default="registered_")
    p.add_argument("--poses", default="poses.npz")
    return p


def _inconsistency(poses, edge):
    """(rotation, translation): the largest entries of |T - edge|, T the
    transform of scan j into scan i that the poses give."""
    from icp_tpu_torch.ops.transform import compose, inverse

    T = compose(poses[edge.j], inverse(poses[edge.i]))
    return (float((T.R - edge.R.to(T.R)).abs().max()),
            float((T.t - edge.t.to(T.t)).abs().max()))


@in_full_float32
def main(argv=None) -> int:
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    if len(args.clouds) < 2:
        print("need at least 2 scans", file=sys.stderr)
        return -1

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("[error] --device cuda: no CUDA device is available", file=sys.stderr)
        return -1

    from icp_tpu_torch.config import ICPConfig
    from icp_tpu_torch.io.csv import load_matrices, write_matrix
    from icp_tpu_torch.ops.padding import resolve_auto_bucket
    from icp_tpu_torch.ops.transform import apply_similarity
    from icp_tpu_torch.slam.pairwise import chain_to_world_poses, register_chain

    dev = args.device
    clouds = load_matrices(args.clouds)
    reg_clouds = [c[::args.subsample] for c in clouds]
    if args.voxel > 0.0:
        from icp_tpu_torch.ops.voxel import voxel_downsample_np

        reg_clouds = [voxel_downsample_np(c, args.voxel, device=dev)[0] for c in reg_clouds]
        for f, c in zip(args.clouds, reg_clouds):
            print(f"[slam] voxel {args.voxel:g}: {f} -> {len(c)} pts", file=sys.stderr)
    cfg = ICPConfig(max_iter=args.max_iter, threshold=args.threshold, solver=args.solver,
                    nn_method=args.nn, with_scale=args.scale, validate_inputs=False,
                    trim_fraction=args.trim)
    if args.bucket < 0:
        bucket_quantum = resolve_auto_bucket(reg_clouds, dev)
    else:
        bucket_quantum = args.bucket or None
    if bucket_quantum:
        print(f"[slam] bucketing on: quantum={bucket_quantum}", file=sys.stderr)
    pairs = register_chain(reg_clouds, cfg, multiscale=tuple(args.multiscale), init=args.init,
                           engine=args.engine, bucket_quantum=bucket_quantum, device=dev)
    for k, pr in enumerate(pairs):
        print(f"[slam] pair {k}->{k+1}: iters={pr.iters} err={pr.err:g}", file=sys.stderr)
    poses = chain_to_world_poses(pairs)

    if args.detect_closures:
        from icp_tpu_torch.slam.closure import (
            chain_edges_from_pairs,
            detect_loop_closures,
            refine_closures,
        )
        from icp_tpu_torch.slam.pose_graph import optimize_pose_graph

        if args.scale:
            print("[slam] note: pose-graph optimization is SE(3); closure edges and the "
                  "optimized poses are rigid", file=sys.stderr)
        cands = detect_loop_closures(reg_clouds, inlier_min=args.closure_min_inliers,
                                     device=dev)
        for c in cands:
            print(f"[slam] closure candidate {c.i}<-{c.j}: inliers={c.inlier_fraction:.2f}",
                  file=sys.stderr)
        closure_edges, _ = refine_closures(reg_clouds, cands, cfg, engine=args.engine,
                                           multiscale=tuple(args.multiscale),
                                           bucket_quantum=bucket_quantum, device=dev)
        if closure_edges:
            chain_edges, suspects = chain_edges_from_pairs(pairs, reg_clouds, device=dev)
            for k in suspects:
                print(f"[slam] chain edge {k}->{k+1} is unverifiable "
                      f"(feature-inliers={chain_edges[k].weight:.3f}, err={pairs[k].err:g}); "
                      f"down-weighted in the pose graph", file=sys.stderr)
            chain_poses = poses
            poses, cost = optimize_pose_graph(poses, chain_edges + closure_edges, n_iters=15,
                                              robust_phi=1.0, device=dev)
            print(f"[slam] pose graph: {len(closure_edges)} closure edge(s), cost={cost:g}",
                  file=sys.stderr)
            for e in closure_edges:
                (r0, t0), (r1, t1) = (_inconsistency(ps, e) for ps in (chain_poses, poses))
                print(f"[slam] closure {e.i}<-{e.j} inconsistency: rot {r0:.4g} -> {r1:.4g}, "
                      f"trans {t0:.4g} -> {t1:.4g}", file=sys.stderr)
        else:
            print("[slam] no loop closures detected", file=sys.stderr)

    if args.refine:
        from icp_tpu_torch.ops.distance import closest_point_indices
        from icp_tpu_torch.slam.pose_graph import bundle_adjust

        # correspondences of consecutive pairs: each point of scan k+1 and
        # its nearest point of scan k under the chain's transform
        corr = []
        for k, pr in enumerate(pairs):
            src = torch.as_tensor(reg_clouds[k + 1], dtype=torch.float32, device=dev)
            tgt = torch.as_tensor(reg_clouds[k], dtype=torch.float32, device=dev)
            idx = closest_point_indices(apply_similarity(src, pr.transform), tgt,
                                        method="bcast")
            corr.append((k, k + 1, tgt[idx.long()], src))
        poses, cost = bundle_adjust(poses, corr, n_iters=8, device=dev)
        print(f"[slam] bundle adjust: cost={cost:g}", file=sys.stderr)

    for k, (cloud, pose) in enumerate(zip(clouds, poses)):
        out = apply_similarity(torch.as_tensor(cloud, dtype=torch.float32, device=dev),
                               pose)
        write_matrix(out.cpu().numpy(), f"{args.output_prefix}{k}.txt")
    np.savez(args.poses, **{f: np.stack([np.asarray(getattr(p, f).cpu()) for p in poses])
                            for f in ("s", "R", "t")})
    print(f"[slam] poses saved to {args.poses}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
