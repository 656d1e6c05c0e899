"""K3: one whole dense ICP iteration in one launch (``csrc/icp_fused.cu``).

Port of ``icp_tpu/kernels/icp_fused.py``.  The launch applies the
cumulative transform of the state block to the raw scene, finds each
point's nearest model point in the expansion form
``((|m|^2 + px*m2x) + py*m2y) + pz*m2z`` against the pre-scaled ``-2m``
model, takes the Horn sums in float64 (one row per 512-point scene block,
left in the workspace), and in its last block to finish runs K2's step
(``kernels/qcp.py``): the solve, the composition and the convergence test,
in place on the state block, the loop control and the error buffer.  Only
those change between iterations; the moved cloud is never written.

``prepare_fused_inputs`` lays the clouds out and, on the card, allocates
the launch's workspace, once a run; ``fused_icp_step`` checks the loop
tensors the first time it sees them, so an iteration is the launch alone.
Its plain version is ``fused_partials_plain`` followed by
``qcp_step_plain``, taken only for CPU tensors.

The pair axis (the counterpart of JAX's ``vmap`` over the ``pallas_call``):
``prepare_fused_inputs`` on (B, N, 3) scenes and (B, M, 3) models lays out
B pairs, each with its own workspace, and ``fused_icp_step`` then takes
(B, 32) states, (B, 4) controls and (B, L) error buffers: one launch an
iteration for all the pairs, each pair's result bit-equal to its own
single-pair launch (the single pair is B = 1).  The plain version runs
pair by pair.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from icp_tpu_torch.kernels import _build
from icp_tpu_torch.kernels.nn_dense import check_points
from icp_tpu_torch.kernels.qcp import CTL_SLOTS, N_SUMS, STATE_SLOTS, qcp_step_plain

# Model-size cap of the fused path on the CPU: the JAX package's (its
# fully unrolled fold range), so the plain versions take the reference's
# branches.  K3 folds any model in chunks; on the card its cap is the
# largest model at which ``scripts/dispatch_sweep.py`` measured it (NVIDIA
# H100 80GB HBM3, 700 W): faster than the pipeline (K1, the float64 sums,
# K2) at every size from 4,096 to 262,144 rows.
MAX_FUSED_MODEL = 5120
MAX_FUSED_MODEL_CUDA = 262144

_PLAIN_BLOCK_ELEMS = 1 << 24


@dataclass(eq=False)
class FusedInputs:
    """Loop-invariant inputs of one run, built once; on the card also the
    launch's workspace, which every launch leaves as it found it (keys all
    ones, counters zero) but for ``rows``, which keep its Horn sums."""

    p0: torch.Tensor  # ([B,] N, 3) float32 raw scene
    mt: torch.Tensor  # ([B,] M, 4) float32 rows [-2x, -2y, -2z, |m|^2]
    keys: Optional[torch.Tensor] = None  # ([B,] N) int64 merge keys
    counts: Optional[torch.Tensor] = None  # ([B,] scene blocks + 1) int32 arrival counters
    rows: Optional[torch.Tensor] = None  # ([B,] scene blocks, 18) float64 sums of the last launch
    _loop: tuple = ()  # the loop tensors last checked, and the launch's pointers

    @property
    def pairs(self) -> Optional[int]:
        """B for inputs laid out with the pair axis, else None."""
        return self.p0.shape[0] if self.p0.ndim == 3 else None


def prepare_fused_inputs(scene: torch.Tensor, model: torch.Tensor) -> FusedInputs:
    """Cast and lay out the clouds for K3, and allocate the workspace of its
    launch on the card (outside the loop): one pair, (N, 3) and (M, 3), or
    B pairs, (B, N, 3) and (B, M, 3), each with its own workspace."""
    p0 = scene.to(torch.float32).contiguous()
    m = model.to(torch.float32)
    mn = (m[..., 0] * m[..., 0] + m[..., 1] * m[..., 1]) + m[..., 2] * m[..., 2]
    mt = torch.cat([-2.0 * m, mn[..., None]], dim=-1).contiguous()
    if p0.ndim == 3:
        if mt.ndim != 3 or mt.shape[0] != p0.shape[0]:
            raise ValueError(f"prepare_fused_inputs: {p0.shape[0]} scenes against models "
                             f"{tuple(model.shape)}")
        for s in p0:
            check_points("prepare_fused_inputs", "scene", s)
    else:
        check_points("prepare_fused_inputs", "scene", p0)
    if mt.device != p0.device or mt.shape[-2] < 1 or p0.shape[-2] < 1:
        raise ValueError("prepare_fused_inputs: the clouds must be non-empty and on one device")
    if p0.device.type == "cpu":
        return FusedInputs(p0=p0, mt=mt)
    if mt.data_ptr() % 16:
        raise ValueError("prepare_fused_inputs: the model rows must be 16-byte aligned")
    dev, blocks = p0.device, _build.lib().icp_fused_scene_blocks(p0.shape[-2])
    lead = p0.shape[:-2]
    return FusedInputs(p0=p0, mt=mt,
                       keys=torch.full((*lead, p0.shape[-2]), -1, dtype=torch.int64, device=dev),
                       counts=torch.zeros((*lead, blocks + 1), dtype=torch.int32, device=dev),
                       rows=torch.zeros((*lead, blocks, N_SUMS), dtype=torch.float64,
                                        device=dev))


def fused_path_available(solver: str, nn_method: str, trim_fraction: float,
                         model: torch.Tensor, masked: bool = False) -> bool:
    """The fused path serves qcp_fused + pallas, untrimmed, unmasked (no
    bucket padding: K3 has no weighted sums, ``icp_tpu/engine/icp.py:337``),
    models (``([B,] M, 3)``) of at most ``MAX_FUSED_MODEL`` points on the
    CPU (as ``icp_fused.py:306``), ``MAX_FUSED_MODEL_CUDA`` on the card."""
    cap = MAX_FUSED_MODEL_CUDA if model.is_cuda else MAX_FUSED_MODEL
    return (solver == "qcp_fused" and nn_method == "pallas" and not masked
            and trim_fraction == 0.0 and model.shape[-2] <= cap)


def _check_loop(prep: FusedInputs, state, ctl, errs) -> tuple:
    """Raise unless the loop tensors are K2's (one pair's, or one each pair
    of ``prep``), beside the clouds; returns the launch's pointer
    arguments."""
    dev, b = prep.p0.device, prep.pairs
    lead = () if b is None else (b,)
    for name, t, dt, shape in (("state", state, torch.float64, (b or 1, STATE_SLOTS)),
                               ("ctl", ctl, torch.int32, (*lead, CTL_SLOTS)),
                               ("errs", errs, torch.float64, None)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous() \
                or (shape is not None and tuple(t.shape) != shape) \
                or (shape is None and (t.ndim != 1 + len(lead) or tuple(t.shape[:-1]) != lead)):
            raise ValueError(f"fused_icp_step: {name} must be a contiguous {dt} "
                             f"{shape or (*lead, 'L')} tensor on {dev} (got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device})")
    if prep.keys is None:
        return ()
    return (prep.p0.data_ptr(), b or 1, prep.p0.shape[-2], prep.mt.data_ptr(),
            prep.mt.shape[-2], state.data_ptr(), ctl.data_ptr(), errs.data_ptr(),
            errs.shape[-1], prep.keys.data_ptr(), prep.counts.data_ptr(),
            prep.rows.data_ptr())


def fused_icp_step(prep: FusedInputs, state: torch.Tensor, ctl: torch.Tensor,
                   errs: torch.Tensor, *, with_scale: bool = True,
                   threshold: float = -math.inf, err_factor: float = 2.0,
                   converge: bool = True, guard: bool = False) -> None:
    """One ICP iteration, in place on ``state`` (1, 32) float64, ``ctl``
    (4,) int32 and ``errs`` float64 (the keywords: K2's loop arguments);
    for B pairs' ``prep``, on ``state`` (B, 32), ``ctl`` (B, 4) and
    ``errs`` (B, L).  On the card it is one launch of K3 for all the
    pairs; the loop tensors are checked the first time a run's ``prep``
    sees them."""
    loop = prep._loop
    if not loop or loop[0] is not state or loop[1] is not ctl or loop[2] is not errs:
        loop = prep._loop = (state, ctl, errs, _check_loop(prep, state, ctl, errs),
                             prep.p0.device.index)
    if prep.keys is None:
        kw = dict(with_scale=with_scale, threshold=threshold, err_factor=err_factor,
                  converge=converge, guard=guard)
        if prep.pairs is None:
            qcp_step_plain(fused_partials_plain(prep, state), state, ctl, errs, **kw)
        for b in range(prep.pairs or 0):
            st = state[b:b + 1]
            one = FusedInputs(p0=prep.p0[b], mt=prep.mt[b])
            qcp_step_plain(fused_partials_plain(one, st), st, ctl[b], errs[b], **kw)
        return
    code = _build.lib().icp_fused_launch(*loop[3], int(with_scale), float(threshold),
                                         float(err_factor), int(converge), int(guard),
                                         _build.raw_stream(loop[4]))
    _build.LAUNCHES["icp_fused"] += 1
    _build.check(code, "icp_fused")


def chunk_rows(n: int, m: int, pairs: int = 1) -> int:
    """The model rows of one of K3's chunks for a launch of ``pairs`` (n, m)
    pairs on the current card (the C launcher's choice: one wave of blocks
    over all the pairs' scene blocks)."""
    import ctypes

    out = ctypes.c_int()
    _build.check(_build.lib().icp_fused_chunk_rows(pairs, n, m, ctypes.addressof(out)),
                 "icp_fused")
    return out.value


def fused_partials_plain(prep: FusedInputs, state: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: the same float32 apply and distance order, the
    same first-index winner, the sums in float64 as one (1, 18) row.  A NaN
    distance never wins, and a scene row with no distance below +inf
    matches y = (0, 0, 0), as the kernel's (and JAX's) zeroed carry gives."""
    p0, mt = prep.p0, prep.mt
    s = state[0, 13].to(torch.float32)
    R = state[0, 14:23].to(torch.float32)
    t = state[0, 23:26].to(torch.float32)
    x, y, z = p0[:, 0], p0[:, 1], p0[:, 2]
    p = torch.stack([s * ((R[3 * r] * x + R[3 * r + 1] * y) + R[3 * r + 2] * z) + t[r]
                     for r in range(3)], dim=1)
    rows = max(1, _PLAIN_BLOCK_ELEMS // mt.shape[0])
    win = torch.empty(p.shape[0], dtype=torch.int64, device=p.device)
    found = torch.empty(p.shape[0], dtype=torch.bool, device=p.device)
    for lo in range(0, p.shape[0], rows):
        q = p[lo:lo + rows]
        d = ((mt[None, :, 3] + q[:, None, 0] * mt[None, :, 0])
             + q[:, None, 1] * mt[None, :, 1]) + q[:, None, 2] * mt[None, :, 2]
        best, win[lo:lo + rows] = torch.min(torch.where(torch.isnan(d), float("inf"), d), dim=1)
        found[lo:lo + rows] = best < float("inf")
    P = p.to(torch.float64)
    Y = torch.where(found[:, None], -0.5 * mt[win, :3], 0.0).to(torch.float64)
    return torch.cat([(P.T @ Y).reshape(-1), P.sum(0), Y.sum(0),
                      (P * P).sum().reshape(1), (Y * Y).sum().reshape(1),
                      torch.tensor([float(P.shape[0])], dtype=torch.float64,
                                   device=P.device)]).reshape(1, N_SUMS)

