"""Similarity alignment solve (Horn quaternion method, with scale).

Port of ``icp_tpu/ops/alignment.py``: given scene points ``p`` and matched
model points ``y``, find ``y ~= s R p + t`` from the sufficient statistics
``(sum_p, sum_y, sum_py, sum_pp, sum_yy, n)`` (reference
``src/cpu.cc:105-175``).  The reference's BUG-1 (an eigenvalue argmax that
never updates its running max, ``src/cpu.cc:81-91``) is not reproduced.

Solvers: ``eigh`` (``torch.linalg.eigh`` on Horn's N), ``qcp`` (Newton on
the quartic characteristic polynomial + adjugate eigenvector, in tensor
ops), ``kabsch`` (3x3 SVD) and ``qcp_fused`` (the rotation-solve CUDA
kernel K5 of ``kernels/qcp.py``, the port of ``horn_rotation_pallas``).

A non-finite Horn matrix (a NaN or Inf coordinate upstream) gives a NaN
rotation, as the JAX solvers give, and not the exception that
``torch.linalg.eigh`` and ``torch.linalg.svd`` raise on it: the solvers run
on a sanitised input and ``torch.where`` puts the NaN back, on the device,
with no host read.  ``icp(..., guard=True)`` then raises
``FloatingPointError`` through its finite check.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from icp_tpu_torch.utils.precision import in_full_float32


class AlignmentStats(NamedTuple):
    """Sufficient statistics of a (p, y) correspondence set (plain sums),
    with any leading batch axes."""

    sum_p: torch.Tensor  # (..., 3)
    sum_y: torch.Tensor  # (..., 3)
    sum_py: torch.Tensor  # (..., 3, 3) = sum_i p_i y_i^T
    sum_pp: torch.Tensor  # (...) = sum_i ||p_i||^2
    sum_yy: torch.Tensor  # (...) = sum_i ||y_i||^2
    n: torch.Tensor  # (...) point count (float)


class Similarity(NamedTuple):
    """A similarity transform y = s * R @ p + t (a batch of them with
    leading axes on every field)."""

    s: torch.Tensor  # (...) scale
    R: torch.Tensor  # (..., 3, 3) rotation
    t: torch.Tensor  # (..., 3) translation


def matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A @ x over leading batch axes (one matrix-vector product unbatched)."""
    return A @ x if x.dim() == 1 else (A @ x.unsqueeze(-1)).squeeze(-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis (``torch.dot`` unbatched)."""
    return torch.dot(a, b) if a.dim() == 1 else (a * b).sum(-1)


def compute_alignment_stats(p: torch.Tensor, y: torch.Tensor, acc_dtype=None,
                            weights: torch.Tensor | None = None) -> AlignmentStats:
    """Accumulate the alignment statistics of (..., N, 3) clouds in
    ``acc_dtype`` (default: ``p.dtype``); leading axes are a batch.
    ``weights`` (..., N): optional per-row weights; ``n`` becomes their sum.

    The 3x3 cross term is a matmul: in float32 it needs full float32, which
    the entry points guarantee (``utils.precision.full_float32``)."""
    acc_dtype = p.dtype if acc_dtype is None else acc_dtype
    pa = p.to(acc_dtype)
    ya = y.to(acc_dtype)
    if weights is None:
        return AlignmentStats(
            sum_p=pa.sum(-2),
            sum_y=ya.sum(-2),
            sum_py=pa.transpose(-1, -2) @ ya,
            sum_pp=(pa * pa).sum((-2, -1)),
            sum_yy=(ya * ya).sum((-2, -1)),
            n=torch.full(p.shape[:-2], float(p.shape[-2]), dtype=acc_dtype, device=p.device),
        )
    w = weights.to(acc_dtype)
    pw = pa * w[..., None]
    return AlignmentStats(
        sum_p=pw.sum(-2),
        sum_y=(ya * w[..., None]).sum(-2),
        sum_py=pw.transpose(-1, -2) @ ya,
        sum_pp=(w * (pa * pa).sum(-1)).sum(-1),
        sum_yy=(w * (ya * ya).sum(-1)).sum(-1),
        n=w.sum(-1),
    )


def horn_n_matrix(S: torch.Tensor) -> torch.Tensor:
    """Horn's symmetric, traceless 4x4 N-matrix of (..., 3, 3) S (reference
    ``src/cpu.cc:121-126``)."""
    def e(i, j):
        return S[..., i, j]

    tr = e(0, 0) + e(1, 1) + e(2, 2)
    A = e(1, 2) - e(2, 1)
    B = e(2, 0) - e(0, 2)
    C = e(0, 1) - e(1, 0)
    rows = [
        [tr, A, B, C],
        [A, e(0, 0) - e(1, 1) - e(2, 2), e(0, 1) + e(1, 0), e(0, 2) + e(2, 0)],
        [B, e(0, 1) + e(1, 0), e(1, 1) - e(0, 0) - e(2, 2), e(1, 2) + e(2, 1)],
        [C, e(0, 2) + e(2, 0), e(1, 2) + e(2, 1), e(2, 2) - e(0, 0) - e(1, 1)],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (..., 4) (w, x, y, z) -> (..., 3, 3) rotations with
    y = R p."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _finite_or_nan(x: torch.Tensor, solve):
    """``solve(x)`` on (..., d, d) matrices, NaN for each matrix that is not
    all finite: the solve runs on the identity there instead, so it cannot
    raise, and the check stays on the device."""
    finite = torch.isfinite(x).all(-1).all(-1)
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    out = solve(torch.where(finite[..., None, None], x, eye))
    finite = finite.reshape(finite.shape + (1,) * (out.dim() - finite.dim()))
    return torch.where(finite, out, torch.full_like(out, float("nan")))


def max_eigvec_eigh(N: torch.Tensor) -> torch.Tensor:
    """Largest-eigenvalue unit eigenvector of each (..., 4, 4) N (eigenvalues
    ascend); NaN for a non-finite N."""
    return _finite_or_nan(N, lambda a: torch.linalg.eigh(a)[1][..., :, -1])


def _adjugate4(A: torch.Tensor) -> torch.Tensor:
    cof = torch.empty_like(A)
    for i in range(4):
        for j in range(4):
            minor = A[..., [r for r in range(4) if r != i], :][..., [c for c in range(4) if c != j]]
            cof[..., i, j] = (-1.0) ** (i + j) * torch.linalg.det(minor)
    return cof.transpose(-1, -2)


def max_eigvec_qcp(N: torch.Tensor, S: torch.Tensor, gp: torch.Tensor,
                   gy: torch.Tensor, newton_iters: int = 12,
                   power_iters: int = 4) -> torch.Tensor:
    """Largest eigenvector of Horn's N via Newton on its characteristic
    polynomial ``l^4 + c2 l^2 + c1 l + c0`` (c2 = -2 tr(S^T S),
    c1 = -8 det S, c0 = det N) from the Cauchy-Schwarz bound
    ``sqrt(gp gy)``, the adjugate of ``N - l I`` and shifted power steps;
    the solve runs on N / (gp + gy).  Leading axes are a batch."""
    dt = N.dtype
    scale = 1.0 / torch.clamp(gp + gy, min=1e-30)
    N, S = N * scale[..., None, None], S * scale[..., None, None]
    gp, gy = gp * scale, gy * scale
    c2 = -2.0 * (S * S).sum((-2, -1))
    c1 = -8.0 * torch.linalg.det(S)
    c0 = torch.linalg.det(N)
    lam0 = torch.sqrt(torch.clamp(gp * gy, min=0.0))
    lam = lam0
    for _ in range(newton_iters):
        p = ((lam * lam + c2) * lam + c1) * lam + c0
        dp = (4.0 * lam * lam + 2.0 * c2) * lam + c1
        dp = torch.where(dp.abs() < torch.finfo(dt).tiny * 4 + 1e-30,
                         torch.ones_like(dp), dp)
        lam = lam - p / dp
    eye = torch.eye(4, dtype=dt, device=N.device)
    adj = _adjugate4(N - lam[..., None, None] * eye)
    norms = (adj * adj).sum(-2)
    v = torch.take_along_dim(adj, torch.argmax(norms, -1)[..., None, None], dim=-1)[..., 0]
    v = torch.where(norms.amax(-1, keepdim=True) < 1e-16, torch.ones_like(v), v)
    B = N + (lam0 + 1.0)[..., None, None] * eye
    tiny = torch.finfo(dt).tiny
    for _ in range(power_iters):
        w = matvec(B, v)
        v = w * torch.rsqrt(torch.clamp((w * w).sum(-1, keepdim=True), min=tiny))
    return v * torch.rsqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=tiny))


def rotation_kabsch(S: torch.Tensor) -> torch.Tensor:
    """Kabsch/Umeyama rotation from each (..., 3, 3) S = sum p' y'^T,
    reflection corrected; NaN for a non-finite S."""

    def solve(a):
        U, _, Vh = torch.linalg.svd(a)
        V = Vh.transpose(-1, -2)
        d = torch.sign(torch.linalg.det(V @ U.transpose(-1, -2)))
        D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
        return V @ D @ U.transpose(-1, -2)

    return _finite_or_nan(S, solve)


def alignment_from_stats(stats: AlignmentStats, *, solver: str = "eigh",
                         with_scale: bool = True) -> Similarity:
    """Closed-form similarity from the sufficient statistics (a batch of
    them with leading axes; ``solver="qcp_fused"`` takes one pair axis at
    most: one launch of K5 for all the pairs)."""
    n = stats.n
    mu_p = stats.sum_p / n[..., None]
    mu_y = stats.sum_y / n[..., None]
    # centred cross-covariance and energies via the shift identities
    S = stats.sum_py - n[..., None, None] * (mu_p[..., :, None] * mu_y[..., None, :])
    gp = stats.sum_pp - n * _dot(mu_p, mu_p)
    gy = stats.sum_yy - n * _dot(mu_y, mu_y)
    if solver == "kabsch":
        R = rotation_kabsch(S)
    elif solver == "qcp_fused":
        # the whole 4x4 solve in one launch of K5 (float64) on S, gp and gy
        # as they are, as JAX's horn_rotation_pallas
        # (icp_tpu/ops/alignment.py:284-292), vmapped over a pair axis
        from icp_tpu_torch.kernels.qcp import qcp_rotation_from

        R, _, _ = qcp_rotation_from(S, gp, gy)
    else:
        N = horn_n_matrix(S)
        if solver == "eigh":
            q = max_eigvec_eigh(N)
        elif solver == "qcp":
            q = max_eigvec_qcp(N, S, gp, gy)
        else:
            raise ValueError(f"unknown solver: {solver}")
        R = quat_to_rot(q / torch.linalg.norm(q, dim=-1, keepdim=True))
    s = torch.sqrt(gy / gp) if with_scale else torch.ones_like(gp)
    t = mu_y - s[..., None] * matvec(R, mu_p)
    return Similarity(s=s, R=R, t=t)


@in_full_float32
def find_alignment(p: torch.Tensor, y: torch.Tensor, *, solver: str = "eigh",
                   with_scale: bool = True,
                   acc_dtype=None) -> Tuple[Similarity, torch.Tensor]:
    """The transform and its residual ``sum ||y - (s R p + t)||^2``
    (reference ``find_alignment``, ``src/cpu.cc:169-174``)."""
    from icp_tpu_torch.ops.transform import residual_error

    stats = compute_alignment_stats(p, y, acc_dtype=acc_dtype)
    sim = alignment_from_stats(stats, solver=solver, with_scale=with_scale)
    return sim, residual_error(p, y, sim)
