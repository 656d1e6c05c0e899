"""The ICP outer loop (port of ``icp_tpu/engine/icp.py``).

Reference counterpart: ``CPU::ICP::find_corresponding`` (``src/cpu.cc:55-79``):
per iteration, closest-point correspondence, Horn similarity solve, apply
and error; stop when the reported error drops below ``threshold`` or at
``max_iter``.  The reported error is QUIRK-1 (``reference_compat``): twice
the mean squared residual.

The loop stays on the device.  On the kernel paths (``solver="qcp_fused"``)
the convergence test runs inside K2's scalar step (its own launch, or the
last block of the fused iteration K3), which writes ``errs[it]``, advances
the iteration count and raises a done flag; after
that every launch is an exact no-op.  The host launches iterations in
chunks of ``_CHUNK`` and reads the flag once per chunk, so iteration counts
and the NaN-tailed error buffer are those of the JAX loop.  In fixed mode
(``icp_fixed_iters``) no error stops the loop: only the bound raises the
flag, so a NaN error runs on to ``n_iters`` as JAX's ``fori_loop`` does,
while ``icp`` stops after it (``not err >= threshold``).  The plain
solvers (``eigh``, ``qcp``, ``kabsch``: the CPU default, or chosen
explicitly, and ``qcp_fused`` with the ``bcast``/``matmul`` NN) record each
error on the host instead — ``torch.linalg.eigh`` synchronises with the
host in any case.

Paths, as in the JAX engine (``icp_tpu/engine/icp.py:160-219``):
  * fused (qcp_fused + pallas, model <= ``MAX_FUSED_MODEL``): one launch
    of K3 per iteration, whose last block runs K2's step; only the state
    block changes, the moved cloud is never written until the one apply
    after the loop;
  * pipeline (qcp_fused + pallas, larger models): NN (K1), matched-point
    gather, float64 Horn sums in torch, K2, and the apply of the step in
    torch;
  * plain solver (every other case): NN, sums in the cloud's dtype, solve
    (K5 for ``qcp_fused``), apply and the explicit residual;
  * grid (``nn_method="grid"``): ``engine/grid.py``.

The entry points run on the card: numpy input goes to ``cuda`` unless the
caller passes ``device="cpu"``, a tensor stays on its own device, and with
no card and no ``device`` they raise rather than move to the CPU.

Accumulating the Horn sums and solving in float64 is a deliberate numerics
choice: the JAX kernels' float32 closed-form residual cancels to noise near
convergence and can stop the grid path one iteration early on cow.
Every entry point runs under ``utils.precision.full_float32``: float32
matmuls in full float32 whatever the caller set (no TF32).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from icp_tpu_torch.config import ICPConfig
from icp_tpu_torch.kernels.icp_fused import (
    fused_icp_step,
    fused_path_available,
    prepare_fused_inputs,
)
from icp_tpu_torch.kernels.qcp import (
    identity_state,
    new_err_buffer,
    new_loop_control,
    pack_stats,
    pack_total_state,
    qcp_step,
    record_error,
    step_similarity,
    unpack_state,
)
from icp_tpu_torch.ops.alignment import (
    Similarity,
    alignment_from_stats,
    compute_alignment_stats,
)
from icp_tpu_torch.ops.distance import closest_point_indices
from icp_tpu_torch.ops.transform import (
    apply_and_error,
    apply_similarity,
    cast_similarity,
    compose,
    identity_similarity,
)
from icp_tpu_torch.utils.precision import in_full_float32

# Iterations launched between two reads of the device's done flag.
_CHUNK = 8


class ICPResult(NamedTuple):
    points: torch.Tensor  # (N, 3) transformed scene cloud
    transform: Similarity  # cumulative similarity: input scene -> points
    err: torch.Tensor  # last reported per-iteration error
    iters: torch.Tensor  # iterations executed (int32)


class ICPTrace(NamedTuple):
    result: ICPResult
    errs: torch.Tensor  # (max_iter,) per-iteration errors, NaN past iters


class LoopState:
    """Device-side loop control of one run: ``ctl`` = [iterations done,
    done flag, bound] (int32) and the float64 error buffer.  ``converge``
    False is fixed mode: only the bound ends the loop."""

    def __init__(self, bound: int, length: int, threshold: float,
                 reference_compat: bool, device, converge: bool = True):
        self.bound = bound
        self.ctl = new_loop_control(bound, device)
        self.errs = new_err_buffer(length, device)
        self.threshold = threshold
        self.converge = converge
        self.err_factor = 2.0 if reference_compat else 1.0

    def step_kw(self, with_scale: bool) -> dict:
        """K2's loop arguments for this run."""
        return dict(with_scale=with_scale, threshold=self.threshold,
                    err_factor=self.err_factor, converge=self.converge)

    def run(self, step: Callable[[], None]) -> None:
        """Call ``step`` until the done flag is up, reading it once per
        chunk of ``_CHUNK`` iterations."""
        launched = 0
        while launched < self.bound:
            k = min(_CHUNK, self.bound - launched)
            for _ in range(k):
                step()
            launched += k
            if int(self.ctl[1]):
                break

    def done(self) -> bool:
        return bool(int(self.ctl[1]))

    def record(self, err_sum: torch.Tensor, n: torch.Tensor) -> None:
        """Host-side bookkeeping of the plain-solver paths."""
        err = float(self.err_factor * err_sum / n)
        record_error(self.ctl, self.errs, err, self.threshold, self.converge)

    def record_on_device(self, err: torch.Tensor) -> torch.Tensor:
        """K2's bookkeeping in tensor ops, with no host read: errs[it] = err,
        it += 1, done at the bound or, in convergence mode, when ``not err
        >= threshold``; nothing changes once done.  Returns the done flag as it stood before this
        iteration (a 0-d bool tensor): the caller gates its update by it, so
        the launches after convergence are exact no-ops."""
        done = self.ctl[1] != 0
        it = self.ctl[0].to(torch.int64)
        slot = it.clamp(max=self.errs.numel() - 1).reshape(1)
        new_err = err.to(self.errs.dtype).reshape(1)
        self.errs.index_copy_(0, slot, torch.where(done, self.errs[slot], new_err))
        stop = it + 1 >= self.bound
        if self.converge:
            stop = stop | ~(err >= self.threshold)
        self.ctl[:2] = torch.stack([torch.where(done, it, it + 1),
                                    (done | stop).to(torch.int64)]).to(torch.int32)
        return done

    def finish(self, points, transform, dtype, trace: bool):
        iters = self.ctl[0].clone()
        last = (iters.to(torch.int64) - 1).clamp(min=0)
        if self.errs.numel():
            err = torch.where(iters > 0, self.errs[last],
                              torch.full_like(self.errs[0], math.inf))
        else:
            err = torch.full((), math.inf, dtype=torch.float64,
                             device=iters.device)
        result = ICPResult(points=points, transform=transform,
                           err=err.to(dtype), iters=iters)
        return ICPTrace(result=result, errs=self.errs.to(dtype)) if trace else result


def target_device(x, device=None) -> torch.device:
    """Where an entry point runs: ``device`` when given, else a tensor's own
    device, else the card.  Without a card, numpy input and no ``device``
    raise: nothing moves to the CPU unless the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if isinstance(x, torch.Tensor):
        return x.device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to "
                           "run on the CPU")
    return torch.device("cuda")


def as_points(x, dtype, device=None) -> torch.Tensor:
    """An (N, 3) tensor of ``dtype`` on ``target_device(x, device)``."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(dtype=dtype, device=target_device(x, device))


@in_full_float32
def icp_step(p: torch.Tensor, model: torch.Tensor, *, solver: str,
             nn_method: str, with_scale: bool, reference_compat: bool,
             acc_dtype=None):
    """One ICP iteration: correspondence -> alignment -> apply + error.
    Returns (p_new, per-iteration Similarity, reported error)."""
    idx = closest_point_indices(p, model, method=nn_method)
    y = model[idx.to(torch.int64)]
    stats = compute_alignment_stats(p, y, acc_dtype=acc_dtype)
    sim = alignment_from_stats(stats, solver=solver, with_scale=with_scale)
    sim = Similarity(*(v.to(p.dtype) for v in sim))
    p_new, err_sum = apply_and_error(p, y, sim)
    n = p.shape[0]
    err = (2.0 * err_sum / n) if reference_compat else (err_sum / n)
    return p_new, sim, err


def _icp_dense(model, scene, *, threshold: float, bound: int, length: int,
               solver: str, nn_method: str, with_scale: bool,
               reference_compat: bool, init: Optional[Similarity], trace: bool,
               converge: bool = True):
    dt, dev = scene.dtype, scene.device
    loop = LoopState(bound, length, threshold, reference_compat, dev, converge)
    step_kw = loop.step_kw(with_scale)
    if fused_path_available(solver, nn_method, 0.0, model.shape[0]):
        prep = prepare_fused_inputs(scene, model)
        state = identity_state(dev) if init is None else pack_total_state(init, dev)
        loop.run(lambda: fused_icp_step(prep, state, loop.ctl, loop.errs, **step_kw))
        total = Similarity(*(v.to(dt) for v in unpack_state(state)[1]))
        return loop.finish(apply_similarity(scene, total), total, dt, trace)

    p = scene if init is None else apply_similarity(scene, init)
    if solver == "qcp_fused" and nn_method == "pallas":
        state = identity_state(dev) if init is None else pack_total_state(init, dev)

        def step():
            nonlocal p
            y = model[closest_point_indices(p, model, method=nn_method).to(torch.int64)]
            stats = compute_alignment_stats(p, y, acc_dtype=torch.float64)
            qcp_step(pack_stats(stats), state, loop.ctl, loop.errs, **step_kw)
            p = apply_similarity(p, step_similarity(state, dt))

        loop.run(step)
        total = Similarity(*(v.to(dt) for v in unpack_state(state)[1]))
        return loop.finish(p, total, dt, trace)

    total = identity_similarity(dt, dev) if init is None else init

    def step():
        nonlocal p, total
        if loop.done():
            return
        y = model[closest_point_indices(p, model, method=nn_method).to(torch.int64)]
        stats = compute_alignment_stats(p, y)
        sim = alignment_from_stats(stats, solver=solver, with_scale=with_scale)
        p, err_sum = apply_and_error(p, y, sim)
        total = compose(total, sim)
        loop.record(err_sum, stats.n)

    loop.run(step)
    return loop.finish(p, total, dt, trace)


def _validate(model, scene, cfg: ICPConfig) -> None:
    """Reference input validation (``src/cpu.cc:42-53``)."""
    if scene.shape[0] < 4:
        raise ValueError("[error] Need at least 4 point pairs")
    if cfg.validate_inputs and scene.shape[0] != model.shape[0]:
        raise ValueError(
            "[error] Point sets need to have the same number of points. "
            "(reference restriction; pass validate_inputs=False to lift it)"
        )


def check_finite(name: str, *tensors) -> None:
    """Host-side NaN/Inf guard (``icp_tpu/utils/profiling.py:check_finite``)."""
    for i, t in enumerate(tensors):
        finite = torch.isfinite(t)
        if not bool(finite.all()):
            bad = t.numel() - int(finite.sum())
            raise FloatingPointError(
                f"{name}: array {i} has {bad} non-finite values "
                f"(shape {tuple(t.shape)}, dtype {t.dtype})")


@in_full_float32
def icp(model, scene, config: Optional[ICPConfig] = None, *, trace: bool = False,
        guard=False, init: Optional[Similarity] = None, n_iters=None, device=None):
    """Register ``scene`` onto ``model``, both (N, 3).

    Returns ``ICPResult`` (or ``ICPTrace`` when ``trace=True``).  Runs on
    ``device`` when given, else on the device of the tensors given, else
    (numpy input) on the card; ``device="cpu"`` is the way onto the CPU.
    ``init``: warm-start Similarity (the returned
    transform still maps the caller's scene).  ``guard=True``: host-side
    NaN/Inf check of the result.  ``n_iters``: an early-exit bound at most
    ``config.max_iter``, for plain runs.
    """
    cfg = config or ICPConfig()
    if n_iters is not None and (trace or guard):
        raise ValueError("n_iters is for plain runs; trace/guard paths "
                         "size buffers by config.max_iter")
    if n_iters is not None and int(n_iters) > cfg.max_iter:
        raise ValueError(
            f"n_iters={int(n_iters)} exceeds config.max_iter={cfg.max_iter}; "
            "n_iters is an early-exit bound, not a replacement "
            "(use ICPConfig(max_iter=...) or icp_fixed_iters)")
    if guard not in (False, True):
        raise NotImplementedError(f"guard={guard!r} is not ported yet "
                                  "(only the host check, guard=True)")
    if cfg.trim_fraction != 0.0:
        raise NotImplementedError("trimmed ICP (trim_fraction > 0) is not "
                                  "ported yet")
    model = as_points(model, cfg.dtype, device)
    scene = as_points(scene, cfg.dtype, model.device)
    _validate(model, scene, cfg)
    backend = scene.device.type
    if init is not None:
        init = cast_similarity(init, cfg.dtype, scene.device)
    n_points = max(model.shape[0], scene.shape[0])
    nn_method = cfg.resolved_nn_method(backend, n_points)
    solver = cfg.resolved_solver(backend)
    bound = cfg.max_iter if n_iters is None else int(n_iters)
    if nn_method == "grid":
        from icp_tpu_torch.engine.grid import _icp_grid

        out = _icp_grid(
            model, scene, threshold=cfg.threshold, bound=bound,
            length=cfg.max_iter, solver=solver, with_scale=cfg.with_scale,
            reference_compat=cfg.reference_compat,
            scene_tile_target=cfg.grid_scene_tile,
            model_tile_target=cfg.grid_model_tile,
            max_candidates=cfg.grid_max_candidates, init=init, trace=trace)
    else:
        out = _icp_dense(
            model, scene, threshold=cfg.threshold, bound=bound,
            length=cfg.max_iter, solver=solver, nn_method=nn_method,
            with_scale=cfg.with_scale, reference_compat=cfg.reference_compat,
            init=init, trace=trace)
    if guard:
        result = out.result if trace else out
        check_finite("icp", result.err, result.points)
    return out


@in_full_float32
def icp_fixed_iters(model, scene, *, n_iters: int, solver: str = "eigh",
                    nn_method: str = "bcast", with_scale: bool = True,
                    reference_compat: bool = True, device=None) -> ICPResult:
    """Exactly ``n_iters`` float32 iterations with no convergence exit (the
    benchmark workload, JAX's ``fori_loop``): a NaN or any other error does
    not stop it.  ``nn_method="grid"`` runs the grid engine with
    ``ICPConfig``'s default tiles.  Devices as in ``icp``."""
    model = as_points(model, torch.float32, device)
    scene = as_points(scene, torch.float32, model.device)
    kw = dict(threshold=-math.inf, bound=n_iters, length=n_iters, solver=solver,
              with_scale=with_scale, reference_compat=reference_compat,
              init=None, trace=False, converge=False)
    if nn_method == "grid":
        from icp_tpu_torch.engine.grid import _icp_grid

        return _icp_grid(model, scene, **kw)
    return _icp_dense(model, scene, nn_method=nn_method, **kw)
