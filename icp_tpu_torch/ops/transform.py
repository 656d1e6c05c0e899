"""Similarity-transform application, composition and residuals.

Port of ``icp_tpu/ops/transform.py`` (reference ``CPU::err_compute``,
``src/cpu.cc:29-40``, and ``err_compute_alignment``, ``src/cpu.cc:93-103``).
The (N, 3) @ (3, 3) apply is a torch matmul, as the JAX package left it to
XLA.  In float32 it needs full float32, which every entry point sets for
its duration whatever the caller chose (``utils.precision.full_float32``):
TF32 would put a ~1e-3 relative error on every coordinate and an error
floor under convergence.
"""

from __future__ import annotations

import torch

from icp_tpu_torch.ops.alignment import Similarity


def identity_similarity(dtype=torch.float32, device=None) -> Similarity:
    """s=1, R=I, t=0 — the reference's init (``src/cpu.hh:57-59``)."""
    return Similarity(
        s=torch.ones((), dtype=dtype, device=device),
        R=torch.eye(3, dtype=dtype, device=device),
        t=torch.zeros(3, dtype=dtype, device=device),
    )


def cast_similarity(sim: Similarity, dtype, device=None) -> Similarity:
    """``sim`` as tensors of ``dtype`` on ``device`` (numbers and numpy
    arrays accepted)."""
    return Similarity(*(torch.as_tensor(v).to(dtype=dtype, device=device)
                        for v in sim))


def apply_similarity(p: torch.Tensor, sim: Similarity) -> torch.Tensor:
    """p -> s R p + t for an (N, 3) cloud (rows = points)."""
    return p @ (sim.s * sim.R).T + sim.t


def residual_error(p: torch.Tensor, y: torch.Tensor, sim: Similarity) -> torch.Tensor:
    """sum_i ||y_i - (s R p_i + t)||^2 without mutating p."""
    d = y - apply_similarity(p, sim)
    return (d * d).sum()


def apply_and_error(p: torch.Tensor, y: torch.Tensor, sim: Similarity):
    """(transformed p, sum ||y - p_new||^2)."""
    p_new = apply_similarity(p, sim)
    d = y - p_new
    return p_new, (d * d).sum()


def compose(inner: Similarity, outer: Similarity) -> Similarity:
    """Apply ``inner`` first, then ``outer``: x -> s_o R_o (s_i R_i x + t_i) + t_o."""
    return Similarity(
        s=outer.s * inner.s,
        R=outer.R @ inner.R,
        t=outer.s * (outer.R @ inner.t) + outer.t,
    )


def inverse(sim: Similarity) -> Similarity:
    """x -> (1/s) R^T (x - t)."""
    s_inv = 1.0 / sim.s
    R_inv = sim.R.T
    return Similarity(s=s_inv, R=R_inv, t=-s_inv * (R_inv @ sim.t))
