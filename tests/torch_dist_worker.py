"""One rank of the port's multi-process tests: a gloo group of CPU
processes running the sharded engines of ``icp_tpu_torch``.

    python -m tests.torch_dist_worker SUITE RANK WORLD ADDRESS OUT_DIR

Each rank joins the group through ``init_distributed`` over
``tcp://ADDRESS``, runs every case of SUITE on the same full inputs and
saves its results to ``OUT_DIR/rank{RANK}.npz`` (keys ``case.field``).
``run_ranks`` starts the WORLD ranks of a suite, once per test module, and
reads the results back.  The inputs are built here with numpy from seeds,
so the test modules hand the same arrays to JAX.  This module imports
nothing of JAX: the ranks never load it.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120  # per spawn of a suite's ranks


# ---------------------------------------------------------------------------
# inputs (numpy, seeded; the test modules build JAX's from the same calls)
# ---------------------------------------------------------------------------


def cow_pair(step: int = 10):
    load = lambda name: np.loadtxt(os.path.join(ROOT, "data", name), delimiter=",", skiprows=1)
    return (np.ascontiguousarray(load("cow_ref.txt")[::step]),
            np.ascontiguousarray(load("cow_tr1.txt")[::step]))


def rotation(rng) -> np.ndarray:
    R = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    if np.linalg.det(R) < 0:
        R[:, 0] = -R[:, 0]
    return R


def odd_case(seed: int = 3, scale: float = 1.4):
    """291 scene and 1,037 model points: neither divides the ranks."""
    rng = np.random.default_rng(seed)
    R = rotation(rng)
    model = rng.standard_normal((1037, 3))
    return model, scale * (model[:291] @ R.T) + np.array([0.2, -0.4, 0.6])


def surface_case(seed: int, n_model: int, n_scene: int):
    """A wavy surface and its first rows moved by a small rigid motion."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1, 1, (n_model, 2))
    model = np.column_stack([xy, 0.25 * np.sin(3 * xy[:, 0]) * np.cos(2 * xy[:, 1])])
    w = 0.05 * rng.standard_normal(3)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    U, _, Vt = np.linalg.svd(np.eye(3) + K)
    R = U @ Vt
    t = 0.05 * rng.standard_normal(3)
    return model, (model[:n_scene] - t) @ R


def outlier_case(seed: int = 5):
    """400 points moved by a rotation of 0.2 rad about z, every tenth 5
    units off: float32, for the trimmed grid."""
    rng = np.random.default_rng(seed)
    model = rng.standard_normal((400, 3)).astype(np.float32)
    c, s = np.cos(0.2), np.sin(0.2)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    scene = model @ R.T + np.float32([0.05, -0.03, 0.08])
    scene[::10] += 5.0
    return model, scene


def quantile_case(seed: int = 11, n: int = 1000):
    """Squared distances with ties and a 0/1 mask."""
    rng = np.random.default_rng(seed)
    d2 = np.round(rng.exponential(1.0, n), 2)
    return d2, (rng.uniform(size=n) > 0.1).astype(np.float64)


def ba_case(seed: int = 21, n_poses: int = 3):
    """(poses as (R, t), correspondences) of a small bundle adjustment."""
    rng = np.random.default_rng(seed)
    poses = [(np.eye(3), np.zeros(3))]
    for _ in range(n_poses - 1):
        w = 0.05 * rng.standard_normal(3)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        U, _, Vt = np.linalg.svd(np.eye(3) + K)
        poses.append((U @ Vt, 0.05 * rng.standard_normal(3)))
    corr = []
    for a in range(n_poses - 1):
        x = rng.standard_normal((101 + 40 * a, 3)).astype(np.float32)
        y = (x + 0.01 * rng.standard_normal(x.shape)).astype(np.float32)
        corr.append((a, a + 1, x, y))
    return poses, corr


# ---------------------------------------------------------------------------
# the suites (run on every rank)
# ---------------------------------------------------------------------------


def _fields(out) -> dict:
    """The arrays of an ICPResult or ICPTrace."""
    res = out.result if hasattr(out, "result") else out
    d = dict(points=res.points.numpy(), iters=np.asarray(int(res.iters)),
             err=np.asarray(float(res.err)), R=res.transform.R.numpy(),
             t=res.transform.t.numpy(), s=np.asarray(float(res.transform.s)))
    if hasattr(out, "result"):
        d["errs"] = out.errs.numpy()
    return d


def _cfg(**kw):
    import torch

    from icp_tpu_torch import ICPConfig

    base = dict(max_iter=20, dtype=torch.float64, solver="eigh", nn_method="bcast")
    base.update(kw)
    return ICPConfig(**base)


def _gathered_fold(fold, p, m, mesh) -> dict:
    """``fold(p_loc, m_loc, axis)`` on this rank's rows; the global indices
    (and matched points) of every rank gathered."""
    import torch

    from icp_tpu_torch.parallel.mesh import shard_rows
    from icp_tpu_torch.parallel.sharded import Axis, gather_rows

    axis = Axis(mesh, "points")
    pt, gi = fold(shard_rows(torch.as_tensor(p), mesh), shard_rows(torch.as_tensor(m), mesh),
                  axis)
    return dict(gi=gather_rows(gi, axis).numpy(), pt=gather_rows(pt, axis).numpy())


def _refused(fn) -> np.ndarray:
    try:
        fn()
    except ValueError as e:
        return np.asarray(str(e))
    return np.asarray("")


def suite_sharded() -> dict:
    """The dense ring and all-gather engines, the 2-D mesh, the quantile
    and the dense plane engines (4 ranks)."""
    import torch

    from icp_tpu_torch import (
        icp_generalized_sharded,
        icp_point_to_plane_sharded,
        icp_sharded,
        icp_sharded_2d,
        icp_symmetric_sharded,
        make_mesh,
        make_mesh_2d,
    )
    from icp_tpu_torch.ops.normals import estimate_normals
    from icp_tpu_torch.ops.quantile import histogram_quantile
    from icp_tpu_torch.parallel.mesh import shard_rows
    from icp_tpu_torch.parallel.sharded import _ring_correspond

    mesh = make_mesh("cpu")
    ref, tr1 = cow_pair()
    out = {}
    out["ring"] = _fields(icp_sharded(ref, tr1, _cfg(), mesh=mesh, trace=True))
    out["allgather"] = _fields(icp_sharded(ref, tr1, _cfg(), mesh=mesh, ring=False))
    out["pallas"] = _fields(icp_sharded(ref, tr1, _cfg(nn_method="pallas"), mesh=mesh,
                                        trace=True))
    out["trimmed"] = _fields(icp_sharded(ref, tr1, _cfg(trim_fraction=0.1), mesh=mesh))
    model, scene = odd_case()
    out["odd"] = _fields(icp_sharded(model, scene, _cfg(validate_inputs=False, max_iter=40),
                                     mesh=mesh))
    out["n_iters"] = _fields(icp_sharded(ref, tr1, _cfg(max_iter=4), mesh=mesh, n_iters=3))
    out["bound"] = dict(msg=_refused(lambda: icp_sharded(ref, tr1, _cfg(), mesh=mesh,
                                                         trace=True, n_iters=99)))

    rng = np.random.default_rng(1)
    p, m = rng.standard_normal((64, 3)), rng.standard_normal((160, 3))
    for impl in ("jnp", "pallas"):
        fold = lambda pl, ml, ax: _ring_correspond(pl, ml, ax, impl)[:2]
        out[f"indices_{impl}"] = _gathered_fold(fold, p, m, mesh)
        out[f"ties_{impl}"] = _gathered_fold(fold, np.tile([[1.0, 2.0, 3.0]], (16, 1)),
                                             np.ones((80, 3)), mesh)

    d2, w = quantile_case()
    t_d2, t_w = torch.as_tensor(d2), torch.as_tensor(w)
    group = mesh.get_group("points")
    out["quantile"] = dict(
        sharded=histogram_quantile(shard_rows(t_d2, mesh), 0.7, shard_rows(t_w, mesh),
                                   group=group).numpy(),
        single=histogram_quantile(t_d2, 0.7, t_w).numpy())

    mesh2 = make_mesh_2d(2, 2, "cpu")
    out["mesh2d"] = _fields(icp_sharded_2d(ref, tr1, _cfg(), mesh=mesh2, trace=True))
    out["mesh2d_odd"] = _fields(icp_sharded_2d(*odd_case(4, 1.2),
                                               _cfg(validate_inputs=False, max_iter=40),
                                               mesh=mesh2))
    out["mesh2d_trimmed"] = _fields(icp_sharded_2d(ref, tr1, _cfg(trim_fraction=0.1),
                                                   mesh=mesh2))

    model, scene = surface_case(6, 500, 400)
    mn = estimate_normals(torch.as_tensor(model), k=12, device="cpu")
    sn = estimate_normals(torch.as_tensor(scene), k=12, device="cpu")
    out["normals"] = dict(model=mn.numpy(), scene=sn.numpy())
    plane = _cfg(max_iter=25, validate_inputs=False, threshold=1e-12)
    out["p2pl"] = _fields(icp_point_to_plane_sharded(model, scene, plane, normals=mn,
                                                     mesh=mesh, trace=True))
    out["p2pl_trimmed"] = _fields(icp_point_to_plane_sharded(
        model, scene, _cfg(max_iter=25, validate_inputs=False, threshold=1e-12,
                           trim_fraction=0.1), normals=mn, mesh=mesh))
    out["sym"] = _fields(icp_symmetric_sharded(model, scene, plane, normals=mn,
                                               scene_normals=sn, mesh=mesh, trace=True))
    out["gicp"] = _fields(icp_generalized_sharded(model, scene, plane, model_normals=mn,
                                                  scene_normals=sn, mesh=mesh, trace=True))
    return out


def suite_grid() -> dict:
    """The grid ring: point-to-point, overflow, ties, trim, the plane
    engines (2 ranks)."""
    import torch

    from icp_tpu_torch import (
        icp_generalized_sharded,
        icp_point_to_plane_sharded,
        icp_sharded,
        icp_symmetric_sharded,
        make_mesh,
    )
    from icp_tpu_torch.kernels.nn_grid import build_model_grid
    from icp_tpu_torch.ops.normals import estimate_normals
    from icp_tpu_torch.parallel.sharded_grid import _ring_correspond_grid

    mesh = make_mesh("cpu")
    ref, tr1 = cow_pair()
    grid = dict(nn_method="grid", grid_model_tile=128, grid_scene_tile=64)
    out = {}
    out["grid"] = _fields(icp_sharded(ref, tr1, _cfg(**grid), mesh=mesh, trace=True))
    out["dense"] = _fields(icp_sharded(ref, tr1, _cfg(), mesh=mesh))
    out["overflow"] = _fields(icp_sharded(ref, tr1, _cfg(**grid, grid_max_candidates=1),
                                          mesh=mesh))
    model, scene = odd_case()
    out["odd"] = _fields(icp_sharded(model, scene, _cfg(**grid, validate_inputs=False,
                                                        max_iter=40), mesh=mesh))
    model, scene = outlier_case()
    out["trimmed"] = _fields(icp_sharded(model, scene, _cfg(
        **grid, dtype=torch.float32, trim_fraction=0.2, max_iter=40, threshold=1e-8,
        validate_inputs=False, with_scale=False), mesh=mesh))
    out["n_iters"] = _fields(icp_sharded(ref[::2], tr1[::2], _cfg(**grid, max_iter=4),
                                         mesh=mesh, n_iters=3))
    out["bound"] = dict(msg=_refused(lambda: icp_sharded(ref[::2], tr1[::2], _cfg(**grid),
                                                         mesh=mesh, trace=True, n_iters=99)))

    base = np.random.default_rng(7).standard_normal((64, 3)).astype(np.float32)

    def ties(p_loc, m_loc, axis):
        g = build_model_grid(m_loc, target_tile=128)
        y, gi, _, _ = _ring_correspond_grid(
            p_loc, torch.full((p_loc.shape[0],), 3.0e38), g, axis,
            m_shard=m_loc.shape[0], scene_tile=8, max_candidates=32)
        return y, gi

    out["ties"] = _gathered_fold(ties, base[:16], np.concatenate([base, base]), mesh)

    model, scene = surface_case(8, 1100, 800)
    mn = estimate_normals(torch.as_tensor(model), k=12, device="cpu")
    sn = estimate_normals(torch.as_tensor(scene), k=12, device="cpu")
    out["normals"] = dict(model=mn.numpy(), scene=sn.numpy())
    plane = _cfg(max_iter=25, validate_inputs=False, threshold=1e-12, **grid)
    out["p2pl"] = _fields(icp_point_to_plane_sharded(model, scene, plane, normals=mn,
                                                     mesh=mesh, trace=True))
    out["sym"] = _fields(icp_symmetric_sharded(model, scene, plane, normals=mn,
                                               scene_normals=sn, mesh=mesh, trace=True))
    out["gicp"] = _fields(icp_generalized_sharded(model, scene, plane, model_normals=mn,
                                                  scene_normals=sn, mesh=mesh, trace=True))
    out["gicp_trimmed"] = _fields(icp_generalized_sharded(
        model, scene, _cfg(max_iter=25, validate_inputs=False, threshold=1e-12,
                           trim_fraction=0.1, **grid),
        model_normals=mn, scene_normals=sn, mesh=mesh))
    return out


GN_GRID_ENGINES = ("point_to_plane", "symmetric", "gicp")


def suite_gn_grid() -> dict:
    """The public ``gn_sharded_grid`` (JAX's signature) for the three plane
    engines at this group's size, its config's NN method ``"bcast"`` (the
    entry runs the grid loop whatever it says), the normals given; and the
    symmetric engine with both clouds' normals left to it, beside the same
    call given the port's ``estimate_normals`` of each cloud."""
    import torch

    from icp_tpu_torch import make_mesh
    from icp_tpu_torch.ops.normals import estimate_normals
    from icp_tpu_torch.parallel.sharded_grid import gn_sharded_grid

    mesh = make_mesh("cpu")
    model, scene = surface_case(8, 1100, 800)
    mn = estimate_normals(torch.as_tensor(model), k=12, device="cpu")
    sn = estimate_normals(torch.as_tensor(scene), k=12, device="cpu")
    cfg = _cfg(max_iter=25, validate_inputs=False, threshold=1e-12, grid_model_tile=128,
               grid_scene_tile=64)
    out = {"normals": dict(model=mn.numpy(), scene=sn.numpy())}
    for engine in GN_GRID_ENGINES:
        out[engine] = _fields(gn_sharded_grid(model, scene, cfg, engine=engine, model_normals=mn,
                                              scene_normals=sn, mesh=mesh, trace=True))
    out["estimated"] = _fields(gn_sharded_grid(model, scene, cfg, engine="symmetric",
                                               normal_k=12, mesh=mesh))
    out["estimated_given"] = _fields(gn_sharded_grid(
        model, scene, cfg, engine="symmetric", mesh=mesh,
        model_normals=estimate_normals(torch.as_tensor(model), k=12, device="cpu"),
        scene_normals=estimate_normals(torch.as_tensor(scene), k=12, device="cpu")))
    return out


def suite_distributed() -> dict:
    """The dense ring over two processes, and the bundle adjustment."""
    import torch

    from icp_tpu_torch import Similarity, bundle_adjust, bundle_adjust_sharded, icp_sharded
    from icp_tpu_torch import make_mesh

    from icp_tpu_torch.parallel.mesh import check_backend

    mesh = make_mesh("cpu")
    ref, tr1 = cow_pair(20)
    out = {"ring": _fields(icp_sharded(ref, tr1, _cfg(), mesh=mesh))}
    elsewhere = torch.zeros((8, 3), device="meta")  # a cloud on no device the mesh serves
    out["refusals"] = dict(
        cloud=_refused(lambda: icp_sharded(elsewhere, elsewhere, _cfg(), mesh=mesh)),
        backend=_refused(lambda: check_backend(None, "cuda")))
    poses, corr = ba_case()
    poses = [Similarity(torch.tensor(1.0), torch.tensor(R, dtype=torch.float32),
                        torch.tensor(t, dtype=torch.float32)) for R, t in poses]
    for name, fn in (("ba_sharded", lambda: bundle_adjust_sharded(poses, corr, mesh=mesh)),
                     ("ba_single", lambda: bundle_adjust(poses, corr, device="cpu"))):
        got, cost = fn()
        out[name] = dict(R=np.stack([p.R.numpy() for p in got]),
                         t=np.stack([p.t.numpy() for p in got]), cost=np.asarray(cost))
    return out


def suite_bench() -> dict:
    """The harness's sharded parts at this group's size: the scaling cell
    (float32, eigh on the CPU), ``run_cell`` refusing a size the group does
    not have, and ``icp_sharded`` run past ``config.max_iter`` by
    ``n_iters`` (the harness's sharded row)."""
    import torch.distributed as dist

    from icp_tpu_torch import icp_sharded, make_mesh
    from icp_tpu_torch.bench.scaling import run_cell

    world = dist.get_world_size()
    cell = run_cell(world, 64, 2, True, model_points=128, reps=1, device="cpu")
    ref, tr1 = cow_pair(20)
    over = icp_sharded(ref, tr1, _cfg(max_iter=1), mesh=make_mesh("cpu"), n_iters=5)
    return {"cell": {k: np.asarray(cell[k]) for k in ("devices", "points", "iters", "err")},
            "over_max_iter": _fields(over),
            "refusals": dict(size=_refused(lambda: run_cell(world + 1, 64, 2, True,
                                                            model_points=128, device="cpu")))}


SUITES = {"sharded": suite_sharded, "grid": suite_grid, "distributed": suite_distributed,
          "bench": suite_bench, "gn_grid": suite_gn_grid}


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(suite: str, world: int, out_dir) -> list:
    """Start the ``world`` ranks of ``suite`` and return each rank's
    results ({case: {field: array}}); raise with the ranks' errors if one
    fails or the spawn outlives ``TIMEOUT_S``."""
    address = f"localhost:{free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_dist_worker", suite,
                               str(r), str(world), address, str(out_dir)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    deadline = time.monotonic() + TIMEOUT_S
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            if p.returncode != 0:
                errs.append(err[-3000:])
    except subprocess.TimeoutExpired:
        errs.append(f"the ranks of {suite!r} outlived {TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if errs:
        raise RuntimeError("\n".join(errs))
    results = []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as f:
            rank = {}
            for key in f.files:
                case, field = key.split(".", 1)
                rank.setdefault(case, {})[field] = f[key]
            results.append(rank)
    return results


def main(argv) -> int:
    suite, rank, world, address, out_dir = argv
    import torch

    from icp_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    init_distributed(address, int(world), int(rank), devices="cpu")
    try:
        out = SUITES[suite]()
    finally:
        torch.distributed.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{f"{case}.{k}": v for case, fields in out.items() for k, v in fields.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
