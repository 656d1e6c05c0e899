"""Plane-to-plane Generalized-ICP (Segal, Haehnel and Thrun, "Generalized-
ICP", RSS 2009): the reference of the mixes whose entry is
``icp_generalized``, written from the method's definition.

* Normals: each cloud's, by PCA of each point's ``normal_k + 1`` nearest
  points of its own cloud (``icp.pca_normals``).  Each point carries the
  disk covariance ``C = I - (1 - eps) n n^T``: 1 in its tangent plane,
  ``eps`` along its normal, whatever the normal's sign.
* Each iteration matches every scene point ``p`` to its nearest model
  point ``y`` (exact, ``nn.nearest``) and weights the residual ``y - p`` by
  ``M = (C_y + C_p)^-1``, the scene's covariances carried rotated by every
  step so far.  The rigid step ``x = [omega, t]`` solves the Gauss-Newton
  system of ``y - (R p + t) ~ (y - p) + J x`` with ``J = [[p]_x, -I]``:
  ``x = -(A + 1e-9 I)^-1 b``, ``A = sum J^T M J``, ``b = sum J^T M (y - p)``;
  ``R`` is Rodrigues' rotation of ``omega``.
* The error is the mean of ``d^T M d`` over the rows, ``d = y - (R p + t)``
  after the step, with the ``M`` of before it; the loop stops as
  ``icp.py``'s, after the first iteration whose error is not at or above
  ``threshold``, or at ``max_iter``.

The per-row algebra (covariances, inverses, sums, error) is plain torch in
float64 on the run's device (a 1,000,000-row cloud would take minutes as
NumPy on the host); the 6x6 solve and the state's composition are NumPy.
``precision="tf32"`` is the control: every value that enters a product is
first rounded to TF32 (``icp.tf32``), and the state (the moved scene and
its covariances) is kept in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from regbench.reference.icp import DAMPING, Answer, _Arith, _rodrigues, pca_normals, tf32
from regbench.reference.nn import nearest


class _Rows(_Arith):
    """``icp._Arith`` on the per-row tensors of the run's device."""

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(tf32(x.cpu().numpy()), device=x.device) if self.low else x

    def keep(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.float32).to(torch.float64) if self.low else x


def disk_covariances(normals: torch.Tensor, eps: float) -> torch.Tensor:
    """(N, 3) unit normals -> (N, 3, 3) ``I - (1 - eps) n n^T``."""
    eye = torch.eye(3, dtype=normals.dtype, device=normals.device)
    return eye - (1.0 - eps) * normals[:, :, None] * normals[:, None, :]


def _jacobian(p: torch.Tensor) -> torch.Tensor:
    """(N, 3, 6) ``[[p]_x, -I]``: the residual's change with ``[omega, t]``."""
    z = torch.zeros_like(p[:, 0])
    px = torch.stack([torch.stack([z, -p[:, 2], p[:, 1]], -1),
                      torch.stack([p[:, 2], z, -p[:, 0]], -1),
                      torch.stack([-p[:, 1], p[:, 0], z], -1)], -2)
    return torch.cat([px, -torch.eye(3, dtype=p.dtype, device=p.device).expand_as(px)], -1)


def gicp(model, scene, *, max_iter: int, threshold: float, normal_k: int = 16,
         eps: float = 1e-3, model_normals=None, scene_normals=None,
         precision: str = "float64", device: str = "cpu") -> Answer:
    """Rigid plane-to-plane GICP of ``scene`` onto ``model``; the clouds'
    normals from their ``normal_k + 1`` nearest points unless given."""
    ar, rw = _Arith(precision), _Rows(precision)
    dev = torch.device(device)

    def on_dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64), device=dev)

    model = np.asarray(model, dtype=np.float64)
    p = np.asarray(scene, dtype=np.float64)
    if model_normals is None:
        model_normals = pca_normals(model, min(normal_k + 1, model.shape[0]), precision)
    if scene_normals is None:
        scene_normals = pca_normals(p, min(normal_k + 1, p.shape[0]), precision)
    searched, model_t = ar.q(model), on_dev(model)
    cov_m = disk_covariances(rw.q(on_dev(model_normals)), eps)
    cov_p = rw.keep(disk_covariances(rw.q(on_dev(scene_normals)), eps))
    R_tot, t_tot = np.eye(3), np.zeros(3)
    err, it = float("inf"), 0
    while it < max_iter:
        idx = on_dev(nearest(searched, ar.q(p), device)).to(torch.int64)
        pt, y = on_dev(p), model_t[idx]
        M = rw.q(torch.linalg.inv(cov_m[idx] + cov_p))
        J = rw.q(_jacobian(pt))
        JtM = rw.q(J.transpose(1, 2) @ M)
        A = (JtM @ J).sum(0).cpu().numpy()
        b = (JtM @ rw.q(y - pt)[:, :, None]).sum(0)[:, 0].cpu().numpy()
        x = -np.linalg.solve(A + DAMPING * np.eye(6), b)
        R, t = _rodrigues(x[:3]), x[3:]
        p = ar.keep(ar.q(p) @ ar.q(R).T + t)
        Rq = on_dev(ar.q(R))
        cov_p = rw.keep(Rq @ rw.q(cov_p) @ Rq.T)
        R_tot, t_tot = R @ R_tot, R @ t_tot + t
        d = rw.q(y - on_dev(p))
        err = float((d[:, None, :] @ M @ d[:, :, None]).mean())
        it += 1
        if not err >= threshold:
            break
    return Answer(points=p, s=1.0, R=R_tot, t=t_tot, err=err, iters=it)


def answer(model, scene, icp: dict, kwargs: dict, *, precision: str,
           device) -> Answer:
    return gicp(model, scene, max_iter=int(icp["max_iter"]), threshold=float(icp["threshold"]),
                normal_k=int(kwargs.get("normal_k", 16)), eps=float(kwargs.get("eps", 1e-3)),
                precision=precision, device=device)
