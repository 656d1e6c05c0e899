"""K3: one whole dense ICP iteration (``csrc/icp_fused.cu``), then K2.

Port of ``icp_tpu/kernels/icp_fused.py``.  One iteration is two launches on
one stream: K3 applies the cumulative transform of the state block to the
raw scene, finds each point's nearest model point in the expansion form
``((|m|^2 + px*m2x) + py*m2y) + pz*m2z`` against the pre-scaled ``-2m``
model, and reduces the Horn sums in float64 to one row per block; K2
(``kernels/qcp.py``) reduces the rows, solves, composes and runs the
convergence test.  Only the state block, the loop control and the error
buffer change between iterations; the moved cloud is never written.

``fused_partials_plain`` is K3's plain torch version; the wrapper takes it
only for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from icp_tpu_torch.kernels import _build
from icp_tpu_torch.kernels.nn_dense import check_points
from icp_tpu_torch.kernels.qcp import N_SUMS, qcp_step

# Model-size cap of the fused path: the JAX package's value (its fully
# unrolled fold range), kept so the port takes the same branches as the
# reference; not yet measured on the H100.
MAX_FUSED_MODEL = 5120

_PLAIN_BLOCK_ELEMS = 1 << 24


class FusedInputs(NamedTuple):
    """Loop-invariant kernel inputs, built once per run."""

    p0: torch.Tensor  # (N, 3) float32 raw scene
    mt: torch.Tensor  # (M, 4) float32 rows [-2x, -2y, -2z, |m|^2]


def prepare_fused_inputs(scene: torch.Tensor, model: torch.Tensor) -> FusedInputs:
    """Cast and lay out the clouds for K3 (outside the loop)."""
    p0 = scene.to(torch.float32).contiguous()
    m = model.to(torch.float32)
    mn = (m[:, 0] * m[:, 0] + m[:, 1] * m[:, 1]) + m[:, 2] * m[:, 2]
    mt = torch.cat([-2.0 * m, mn[:, None]], dim=1).contiguous()
    return FusedInputs(p0=p0, mt=mt)


def fused_path_available(solver: str, nn_method: str, trim_fraction: float,
                         n_model: int) -> bool:
    """The fused path serves qcp_fused + pallas, untrimmed, models of at
    most ``MAX_FUSED_MODEL`` points (as ``icp_fused.py:306``)."""
    return (solver == "qcp_fused" and nn_method == "pallas"
            and trim_fraction == 0.0 and n_model <= MAX_FUSED_MODEL)


def fused_partials(prep: FusedInputs, state: torch.Tensor,
                   ctl: torch.Tensor) -> torch.Tensor:
    """K3 alone: (P, 18) float64 per-block Horn sums of one iteration."""
    p0, mt = prep
    n = p0.shape[0]
    check_points("fused_partials", "p0", p0)
    if mt.ndim != 2 or mt.shape[1] != 4 or mt.dtype != torch.float32 \
            or not mt.is_contiguous() or mt.device != p0.device or mt.shape[0] < 1:
        raise ValueError("fused_partials: mt must be a contiguous float32 "
                         "(M, 4) tensor beside p0")
    if state.dtype != torch.float64 or state.shape != (1, 32) \
            or state.device != p0.device or ctl.device != p0.device:
        raise ValueError("fused_partials: state must be (1, 32) float64 beside p0")
    if p0.device.type == "cpu":
        return fused_partials_plain(prep, state)
    lib = _build.lib()
    partials = torch.empty((lib.icp_fused_blocks(n), N_SUMS), dtype=torch.float64,
                           device=p0.device)
    code = lib.icp_fused_launch(p0.data_ptr(), n, mt.data_ptr(), mt.shape[0],
                                state.data_ptr(), ctl.data_ptr(),
                                partials.data_ptr(), _build.stream_ptr(p0))
    _build.LAUNCHES["icp_fused"] += 1
    _build.check(code, "icp_fused")
    return partials


def fused_icp_step(prep: FusedInputs, state: torch.Tensor, ctl: torch.Tensor,
                   errs: torch.Tensor, **step_kw) -> None:
    """One ICP iteration, in place on ``state``, ``ctl`` and ``errs``: K3
    then K2 on the same stream (``step_kw``: K2's loop arguments)."""
    qcp_step(fused_partials(prep, state, ctl), state, ctl, errs, **step_kw)


def fused_partials_plain(prep: FusedInputs, state: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: the same float32 apply and distance order, the
    same first-index winner, the sums in float64 as one (1, 18) row."""
    p0, mt = prep
    s = state[0, 13].to(torch.float32)
    R = state[0, 14:23].to(torch.float32)
    t = state[0, 23:26].to(torch.float32)
    x, y, z = p0[:, 0], p0[:, 1], p0[:, 2]
    p = torch.stack([s * ((R[3 * r] * x + R[3 * r + 1] * y) + R[3 * r + 2] * z) + t[r]
                     for r in range(3)], dim=1)
    rows = max(1, _PLAIN_BLOCK_ELEMS // mt.shape[0])
    win = torch.empty(p.shape[0], dtype=torch.int64, device=p.device)
    for lo in range(0, p.shape[0], rows):
        q = p[lo:lo + rows]
        d = ((mt[None, :, 3] + q[:, None, 0] * mt[None, :, 0])
             + q[:, None, 1] * mt[None, :, 1]) + q[:, None, 2] * mt[None, :, 2]
        win[lo:lo + rows] = torch.min(d, dim=1).indices
    P = p.to(torch.float64)
    Y = (-0.5 * mt[win, :3]).to(torch.float64)
    return torch.cat([(P.T @ Y).reshape(-1), P.sum(0), Y.sum(0),
                      (P * P).sum().reshape(1), (Y * Y).sum().reshape(1),
                      torch.tensor([float(P.shape[0])], dtype=torch.float64,
                                   device=P.device)]).reshape(1, N_SUMS)

