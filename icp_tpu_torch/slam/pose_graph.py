"""Pose-graph optimisation and point-level bundle adjustment (port of
``icp_tpu/slam/pose_graph.py``).

  * ``optimize_pose_graph``: Gauss-Newton on SE(3) poses (quaternion +
    translation, the gauge fixed at pose 0 by a large diagonal prior),
    optionally robust (Geman-McClure IRLS with graduated non-convexity).
    Each edge's residual and its Jacobian against its two poses' 14
    parameters come from ``torch.func.vmap(torch.func.jacfwd(...))``; the
    (7P, 7P) normal matrix is assembled from the 7x7 blocks by a
    segmented sum over the blocks sorted by (row pose, column pose), in
    JAX's order of addition, with no atomics: deterministic on the card.
  * ``bundle_adjust``: r_k = T_a x_k - T_b y_k per correspondence, the
    normal equations summed over the points, a damped dense solve;
    ``bundle_adjust_sharded`` splits the correspondences over the ranks of
    a ``points`` mesh, all-reduces the normal equations each step and
    solves them on every rank.

Both run on the device of the poses (the card unless the caller passes
``device="cpu"`` or CPU tensors), in float32 as JAX does.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from icp_tpu_torch.ops.alignment import Similarity, quat_to_rot
from icp_tpu_torch.utils.precision import in_full_float32


class PoseEdge(NamedTuple):
    """Relative-pose constraint: scan j expressed in scan i's frame."""

    i: int
    j: int
    R: torch.Tensor  # (3, 3) measured R_ij
    t: torch.Tensor  # (3,) measured t_ij
    weight: float = 1.0


def _device(poses, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    R = poses[0].R
    if isinstance(R, torch.Tensor):
        return R.device
    from icp_tpu_torch.engine.icp import target_device

    return target_device(R)


def _rot_to_quat_np(R: np.ndarray) -> np.ndarray:
    """Shepperd's method (numerically stable rotation -> quaternion)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = [(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s]
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s, (R[1, 2] + R[2, 1]) / s]
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s, 0.25 * s]
    q = np.array(q)
    return q / np.linalg.norm(q)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def poses_to_params(poses: Sequence[Similarity], device=None) -> torch.Tensor:
    """(P, 7) float32 [q (w, x, y, z), t] of each pose."""
    rows = [np.concatenate([_rot_to_quat_np(_np(p.R).astype(np.float64)),
                            _np(p.t).astype(np.float64)]) for p in poses]
    return torch.tensor(np.stack(rows), dtype=torch.float32, device=device)


def params_to_poses(theta: torch.Tensor) -> list[Similarity]:
    out = []
    for k in range(theta.shape[0]):
        q = theta[k, :4] / torch.linalg.norm(theta[k, :4])
        out.append(Similarity(s=torch.ones((), dtype=theta.dtype, device=theta.device),
                              R=quat_to_rot(q), t=theta[k, 4:7]))
    return out


def _edge_residual(local, R_meas, t_meas, weight):
    """(12,) residual of one edge on its poses' stacked 14 parameters."""
    th_i, th_j = local[:7], local[7:]
    Ri = quat_to_rot(th_i[:4] / torch.linalg.norm(th_i[:4]))
    Rj = quat_to_rot(th_j[:4] / torch.linalg.norm(th_j[:4]))
    r_rot = (Ri.T @ Rj - R_meas).reshape(-1)
    r_t = Ri.T @ (th_j[4:7] - th_i[4:7]) - t_meas
    return weight * torch.cat([r_rot, r_t])


class _BlockSum:
    """Sums of values keyed by block ids, each key's values added in the
    order given (JAX's ``.at[].add`` order), by a segmented reduction over
    the stably sorted keys: no atomics.  The keys are fixed, so the sort
    and the run lengths are computed once."""

    def __init__(self, keys: torch.Tensor, n_keys: int):
        self.order = torch.argsort(keys, stable=True)
        self.ids, self.lengths = torch.unique_consecutive(keys[self.order], return_counts=True)
        self.n_keys = n_keys

    def __call__(self, vals: torch.Tensor) -> torch.Tensor:
        sums = torch.segment_reduce(vals[self.order], "sum", lengths=self.lengths, axis=0)
        out = torch.zeros((self.n_keys,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
        return out.index_copy(0, self.ids, sums)


@in_full_float32
def optimize_pose_graph(poses: Sequence[Similarity], edges: Sequence[PoseEdge], *,
                        n_iters: int = 10, robust_phi: float | None = None,
                        device=None) -> Tuple[list[Similarity], float]:
    """Gauss-Newton pose-graph solve; returns (optimised poses, final cost).

    ``robust_phi``: the Geman-McClure kernel's width in chi-square units of
    the 12-d edge residual (1.0 suits unit-scale rotation residuals); the
    kernel anneals from 1e4 to it over the first two thirds of the
    iterations.  None: plain least squares."""
    dev = _device(poses, device)
    f32 = dict(dtype=torch.float32, device=dev)
    theta = poses_to_params(poses, dev)
    n_poses = theta.shape[0]
    n_params = 7 * n_poses
    ei = torch.tensor([e.i for e in edges], dtype=torch.int64, device=dev)
    ej = torch.tensor([e.j for e in edges], dtype=torch.int64, device=dev)
    eR = torch.stack([torch.as_tensor(_np(e.R), **f32) for e in edges])
    et = torch.stack([torch.as_tensor(_np(e.t), **f32) for e in edges])
    ew = torch.tensor([float(e.weight) for e in edges], **f32)
    poses_ix = torch.arange(n_poses, device=dev)
    # the blocks in JAX's order of addition: (i, i), (i, j), (j, i), (j, j)
    # of every edge, then each pose's quaternion-norm term
    h_sum = _BlockSum(torch.cat([ei * n_poses + ei, ei * n_poses + ej, ej * n_poses + ei,
                                 ej * n_poses + ej, poses_ix * n_poses + poses_ix]),
                      n_poses * n_poses)
    g_sum = _BlockSum(torch.cat([ei, ej]), n_poses)
    jac = torch.func.vmap(torch.func.jacfwd(_edge_residual))
    res = torch.func.vmap(_edge_residual)

    def normal_terms(theta, phi):
        local = torch.cat([theta[ei], theta[ej]], dim=1)
        r, J = res(local, eR, et, ew), jac(local, eR, et, ew)  # (E, 12), (E, 12, 14)
        if phi is not None:  # Geman-McClure IRLS weights, constant in the Jacobian
            sw = torch.sqrt((phi / (phi + (r * r).sum(1))) ** 2)
            r, J = sw[:, None] * r, sw[:, None, None] * J
        He = torch.einsum("eri,erj->eij", J, J)
        ge = torch.einsum("eri,er->ei", J, r)
        q = theta[:, :4]
        qn = (q * q).sum(1) - 1.0
        Jq = torch.nn.functional.pad(2.0 * q, (0, 3))  # (P, 7)
        blocks = torch.cat([He[:, :7, :7], He[:, :7, 7:], He[:, 7:, :7], He[:, 7:, 7:],
                            Jq[:, :, None] * Jq[:, None, :]])
        H = h_sum(blocks).reshape(n_poses, n_poses, 7, 7).permute(0, 2, 1, 3)
        g = g_sum(torch.cat([ge[:, :7], ge[:, 7:]])) + qn[:, None] * Jq
        cost = (r * r).sum() + (qn * qn).sum()
        return H.reshape(n_params, n_params), g.reshape(-1), cost

    gauge = torch.cat([torch.full((7,), 1e8, **f32), torch.full((n_params - 7,), 1e-6, **f32)])
    robust = robust_phi is not None
    phi_0 = torch.tensor(1e4, **f32)
    target = torch.tensor(1.0 if robust_phi is None else robust_phi, **f32)
    n_anneal = max(1, (2 * n_iters) // 3)
    for k in range(n_iters):
        frac = torch.tensor(min(1.0, k / n_anneal), **f32)
        phi = phi_0 * (target / phi_0) ** frac if robust else None
        H, g, _ = normal_terms(theta, phi)
        theta = theta - torch.linalg.solve(H + torch.diag(gauge), g).reshape(n_poses, 7)
    _, _, cost = normal_terms(theta, target if robust else None)
    return params_to_poses(theta), float(cost)


def _point_residual(flat, n_poses: int, a_hot, b_hot, x, y):
    """r = T_a x - T_b y for one correspondence; its poses are picked by
    one-hot rows (exact: one product by 1, the rest by 0), which ``vmap``
    takes where it takes no tensor index."""
    theta = flat.reshape(n_poses, 7)
    ta, tb = a_hot @ theta, b_hot @ theta
    Ra = quat_to_rot(ta[:4] / torch.linalg.norm(ta[:4]))
    Rb = quat_to_rot(tb[:4] / torch.linalg.norm(tb[:4]))
    return (Ra @ x + ta[4:7]) - (Rb @ y + tb[4:7])


def _flatten_correspondences(correspondences):
    a_ids, b_ids, xs, ys = [], [], [], []
    for a, b, x, y in correspondences:
        x, y = _np(x), _np(y)
        if x.shape != y.shape or x.shape[1] != 3:
            raise ValueError("bundle_adjust: each correspondence needs two (n, 3) arrays")
        a_ids.append(np.full((x.shape[0],), a, np.int64))
        b_ids.append(np.full((x.shape[0],), b, np.int64))
        xs.append(x.astype(np.float32))
        ys.append(y.astype(np.float32))
    return (np.concatenate(a_ids), np.concatenate(b_ids), np.concatenate(xs),
            np.concatenate(ys))


def _bundle_adjust(poses, a, b, xs, ys, *, n_iters: int, damping: float, dev,
                   w=None, reduce=None) -> Tuple[list[Similarity], float]:
    """The damped Gauss-Newton steps of ``bundle_adjust`` on the
    correspondence rows (a, b, x, y); ``w``: row weights (0: padding) and
    ``reduce`` the sums over the ranks of a sharded run."""
    n_poses = len(poses)
    flat = poses_to_params(poses, dev).reshape(-1)
    n_params = flat.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    a = torch.nn.functional.one_hot(a, n_poses).to(torch.float32)
    b = torch.nn.functional.one_hot(b, n_poses).to(torch.float32)

    def point_residual(th, a_k, b_k, x_k, y_k):
        return _point_residual(th, n_poses, a_k, b_k, x_k, y_k)

    res = torch.func.vmap(point_residual, in_dims=(None, 0, 0, 0, 0))
    jac = torch.func.vmap(torch.func.jacfwd(point_residual), in_dims=(None, 0, 0, 0, 0))

    def terms(f):
        r, J = res(f, a, b, xs, ys), jac(f, a, b, xs, ys)  # (N, 3), (N, 3, 7P)
        if w is None:
            return (torch.einsum("nri,nrj->ij", J, J), torch.einsum("nri,nr->i", J, r),
                    (r * r).sum())
        Jw = J * w[:, None, None]
        sums = (torch.einsum("nri,nrj->ij", Jw, J), torch.einsum("nri,nr->i", Jw, r),
                (w * (r * r).sum(1)).sum())
        return sums if reduce is None else reduce(*sums)

    gauge = torch.diag(torch.cat([torch.full((7,), 1e8, **f32),
                                  torch.zeros(n_params - 7, **f32)]))
    damp = damping * torch.eye(n_params, **f32)
    for _ in range(n_iters):
        H, g, _ = terms(flat)
        # the quaternion-norm soft constraints: (2 q_p)(2 q_p)^T and
        # 2 q_p (|q_p|^2 - 1) in each pose's quaternion slots
        theta = flat.reshape(n_poses, 7)
        q = theta[:, :4]
        Jq = torch.nn.functional.pad(2.0 * q, (0, 3))  # (P, 7)
        Hq = torch.block_diag(*(Jq[:, :, None] * Jq[:, None, :]))
        gq = (Jq * ((q * q).sum(1) - 1.0)[:, None]).reshape(-1)
        flat = flat - torch.linalg.solve(H + Hq + damp + gauge, g + gq)
    _, _, cost = terms(flat)
    return params_to_poses(flat.reshape(n_poses, 7)), float(cost)


@in_full_float32
def bundle_adjust(poses: Sequence[Similarity],
                  correspondences: Sequence[Tuple[int, int, np.ndarray, np.ndarray]], *,
                  n_iters: int = 8, damping: float = 1e-6,
                  device=None) -> Tuple[list[Similarity], float]:
    """Joint point-level refinement.  ``correspondences``: (scan_a, scan_b,
    points_in_a, points_in_b) tuples, row k of the two arrays one matched
    point in the two scans' frames.  Returns (poses, final cost)."""
    dev = _device(poses, device)
    rows = (torch.as_tensor(v, device=dev) for v in _flatten_correspondences(correspondences))
    return _bundle_adjust(poses, *rows, n_iters=n_iters, damping=damping, dev=dev)


@in_full_float32
def bundle_adjust_sharded(poses: Sequence[Similarity],
                          correspondences: Sequence[Tuple[int, int, np.ndarray, np.ndarray]],
                          *, mesh=None, n_iters: int = 8,
                          damping: float = 1e-6) -> Tuple[list[Similarity], float]:
    """``bundle_adjust`` with the correspondence rows padded (weight 0) and
    split over the ranks of a ``points`` mesh (``parallel/mesh.make_mesh``;
    with none, a mesh on the poses' device): the normal equations are
    all-reduced each Gauss-Newton step and the dense solve runs on every
    rank.  Every rank passes the same poses and correspondences and gets
    the same result."""
    from icp_tpu_torch.parallel.mesh import make_mesh, mesh_device, shard_rows
    from icp_tpu_torch.parallel.sharded import reducer

    mesh = mesh or make_mesh(_device(poses, None).type)
    dev = mesh_device(mesh)
    a, b, xs, ys = (torch.as_tensor(v, device=dev)
                    for v in _flatten_correspondences(correspondences))
    w = torch.ones(xs.shape[0], dtype=torch.float32, device=dev)
    a, b, xs, ys, w = (shard_rows(v, mesh) for v in (a, b, xs, ys, w))
    return _bundle_adjust(poses, a, b, xs, ys, n_iters=n_iters, damping=damping, dev=dev,
                          w=w, reduce=reducer(mesh.get_group(mesh.mesh_dim_names[0])))
