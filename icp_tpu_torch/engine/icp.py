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
  * fused (qcp_fused + pallas, model within the fused cap
    (``kernels/icp_fused.fused_path_available``), untrimmed and not
    bucket-padded): one launch of K3 per iteration, whose last block
    runs K2's step; only the state block changes, the moved cloud is never
    written until the one apply after the loop;
  * pipeline (qcp_fused + pallas otherwise): NN (K1), matched-point
    gather, the trim and bucket weights, float64 Horn sums in torch, K2
    (which takes n from the weighted sums, so the error is the weighted
    mean), and the apply of the step in torch;
  * plain solver (every other case): NN, weights, sums in the cloud's
    dtype, solve (K5 for ``qcp_fused``), apply and the explicit residual;
  * grid (``nn_method="grid"``): ``engine/grid.py``.

Trimmed ICP (``trim_fraction > 0``) keeps the ``1 - trim_fraction`` best
correspondences by squared distance, the threshold from the histogram
quantile (``ops/quantile.py``) with no host read.  Bucket padding
(``scene_n``/``model_n``, ``ops/padding.py``) replica-fills the pad rows
and gives them weight 0 in every sum, quantile and mean; the dispatch
(``auto`` NN) reads the true counts, not the padded shape.
``guard="device"`` carries K2's status word (``kernels/qcp.py``): a
non-finite or >100x-diverged error stops the loop on the device and the
host raises ``ICPGuardError`` after it.

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

import dataclasses
import math
import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from icp_tpu_torch.config import ICPConfig
from icp_tpu_torch.kernels.icp_fused import (
    fused_icp_step,
    fused_path_available,
    prepare_fused_inputs,
)
from icp_tpu_torch.kernels.nn_grid import sqnorm_rows
from icp_tpu_torch.kernels.qcp import (
    DIVERGE_FACTOR,
    GUARD_DIVERGED,
    GUARD_NONFINITE,
    GUARD_OK,
    guard_status,
    identity_state,
    least,
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
from icp_tpu_torch.ops.padding import replica_fill, valid_mask
from icp_tpu_torch.ops.quantile import histogram_quantile
from icp_tpu_torch.ops.transform import (
    apply_and_error,
    apply_similarity,
    cast_similarity,
    compose,
    identity_similarity,
)
from icp_tpu_torch.utils.profiling import check_finite, count, host_wait, register, span
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


class ICPGuardError(RuntimeError):
    """Raised by ``icp(guard="device")`` when the loop stops on a
    non-finite or diverging error (status and iteration in the message)."""


def _raise_on_guard_status(result: ICPResult, status: int) -> None:
    """Raise ``ICPGuardError`` for a guard status other than ok, with JAX's
    messages (``icp_tpu/engine/icp.py:486``)."""
    if status == GUARD_NONFINITE:
        raise ICPGuardError(
            f"non-finite error at iteration {int(result.iters)} "
            f"(err={float(result.err)!r}) — input cloud or transform "
            f"produced NaN/Inf; loop aborted on device")
    if status == GUARD_DIVERGED:
        raise ICPGuardError(
            f"error diverged (> {DIVERGE_FACTOR:.0f}x best) at iteration "
            f"{int(result.iters)}: err={float(result.err):.3e}")


class LoopState:
    """Device-side loop control of one run: ``ctl`` = [iterations done,
    done flag, bound, guard status] (int32) and the float64 error buffer.
    ``converge`` False is fixed mode: only the bound ends the loop.
    ``guard`` True is ``guard="device"``: a non-finite error, or one above
    ``DIVERGE_FACTOR`` times the least so far, also ends it and sets the
    status, which ``finish`` raises as ``ICPGuardError``."""

    def __init__(self, bound: int, length: int, threshold: float,
                 reference_compat: bool, device, converge: bool = True,
                 guard: bool = False):
        # a negative count runs no iteration, as the reference's loop
        bound, length = max(int(bound), 0), max(int(length), 0)
        self.bound = bound
        self.ctl = new_loop_control(bound, device)
        self.errs = new_err_buffer(length, device)
        self.threshold = threshold
        self.converge = converge
        self.guard = guard
        self.err_factor = 2.0 if reference_compat else 1.0
        self.best = math.inf  # the guard's least error so far (the host loops')

    def step_kw(self, with_scale: bool) -> dict:
        """K2's loop arguments for this run."""
        return dict(with_scale=with_scale, threshold=self.threshold,
                    err_factor=self.err_factor, converge=self.converge, guard=self.guard)

    def run(self, step: Callable[[], None]) -> None:
        """Call ``step`` until the done flag is up, reading it once per
        chunk of ``_CHUNK`` iterations."""
        with span("icp.loop", self.ctl):
            launched = 0
            while launched < self.bound:
                k = min(_CHUNK, self.bound - launched)
                for _ in range(k):
                    step()
                launched += k
                count("iters_launched", k)
                with host_wait():
                    done = int(self.ctl[1])
                if done:
                    break

    def done(self) -> bool:
        with host_wait():
            return bool(int(self.ctl[1]))

    def record(self, err_sum: torch.Tensor, n: torch.Tensor) -> None:
        """Host-side bookkeeping of the plain-solver paths."""
        with host_wait():
            err = float(self.err_factor * err_sum / n)
            status = GUARD_OK
            if self.guard:
                status = guard_status(err, self.best)
                self.best = least(err, self.best)
            record_error(self.ctl, self.errs, err, self.threshold, self.converge, status)

    def record_on_device(self, err: torch.Tensor) -> torch.Tensor:
        """K2's bookkeeping in tensor ops, with no host read: errs[it] = err,
        it += 1, done at the bound, and in convergence mode when ``not err >=
        threshold``; nothing changes once done.  Returns the done flag as it
        stood before this iteration (a 0-d bool tensor): the caller gates its
        update by it, so the launches after convergence are exact no-ops.
        Unguarded: its callers, the plane engines, take no guard (as JAX's)."""
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
        count("iters_done", iters)
        last = (iters.to(torch.int64) - 1).clamp(min=0)
        if self.errs.numel():
            with host_wait():  # indexing by a 0-d device tensor reads it
                err = torch.where(iters > 0, self.errs[last],
                                  torch.full_like(self.errs[0], math.inf))
        else:
            err = torch.full((), math.inf, dtype=torch.float64,
                             device=iters.device)
        result = ICPResult(points=points, transform=transform,
                           err=err.to(dtype), iters=iters)
        if self.guard:  # the status, read once after the loop
            with host_wait():
                status = int(self.ctl[3])
            _raise_on_guard_status(result, status)
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


def trim_weights(p: torch.Tensor, y: torch.Tensor, trim_fraction: float,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Trimmed-ICP weights: 1 for the ``1 - trim_fraction`` best
    correspondences by squared distance (K4's summation order), times the
    bucket mask, whose pad rows the quantile leaves out."""
    d2 = sqnorm_rows(y - p)
    tau = histogram_quantile(d2, 1.0 - trim_fraction, mask)
    w = (d2 <= tau).to(p.dtype)
    return w if mask is None else w * mask


def step_weights(p, y, trim_fraction: float, mask):
    """The weights of one dense iteration: the trim's, the bucket mask, or
    None (the unweighted sums)."""
    if trim_fraction > 0.0:
        return trim_weights(p, y, trim_fraction, mask)
    return mask


def bucket_prologue(model, scene, scene_n, model_n):
    """Bucket padding before the loop: the pad rows of both clouds become
    replicas of the last real row, and the scene gets a validity mask.
    Returns (model, scene, scene mask or None)."""
    mask = None
    if scene_n is not None:
        scene = replica_fill(scene, scene_n)
        mask = valid_mask(scene.shape[0], scene_n, scene.dtype, scene.device)
    if model_n is not None:
        model = replica_fill(model, model_n)
    return model, scene, mask


def true_count(rows: int, n_valid) -> int:
    """The real rows of a cloud of ``rows`` rows with valid count
    ``n_valid`` (None: every row), for the dispatch."""
    return rows if n_valid is None else int(n_valid)


def _plain_step(p, model, *, solver: str, nn_method: str, with_scale: bool,
                acc_dtype=None, trim_fraction: float = 0.0, mask=None):
    """NN, weights, sums, solve and apply: (p_new, Similarity in p's dtype,
    residual sum, n) with the residual and n weighted as the sums."""
    y = model[closest_point_indices(p, model, method=nn_method).to(torch.int64)]
    w = step_weights(p, y, trim_fraction, mask)
    stats = compute_alignment_stats(p, y, acc_dtype=acc_dtype, weights=w)
    sim = alignment_from_stats(stats, solver=solver, with_scale=with_scale)
    sim = Similarity(*(v.to(p.dtype) for v in sim))
    if w is None:
        p_new, err_sum = apply_and_error(p, y, sim)
    else:
        p_new = apply_similarity(p, sim)
        d = y - p_new
        err_sum = (w * (d * d).sum(1)).sum()
    return p_new, sim, err_sum, stats.n.to(err_sum.dtype)


@in_full_float32
def icp_step(p: torch.Tensor, model: torch.Tensor, *, solver: str,
             nn_method: str, with_scale: bool, reference_compat: bool,
             acc_dtype=None, trim_fraction: float = 0.0, scene_mask=None):
    """One ICP iteration: correspondence -> alignment -> apply + error.
    ``scene_mask``: the (N,) bucket validity mask (pad rows 0).  Returns
    (p_new, per-iteration Similarity, reported error)."""
    p_new, sim, err_sum, n = _plain_step(p, model, solver=solver, nn_method=nn_method,
                                         with_scale=with_scale, acc_dtype=acc_dtype,
                                         trim_fraction=trim_fraction, mask=scene_mask)
    err = (2.0 * err_sum / n) if reference_compat else (err_sum / n)
    return p_new, sim, err


def _icp_dense(model, scene, *, threshold: float, bound: int, length: int,
               solver: str, nn_method: str, with_scale: bool,
               reference_compat: bool, init: Optional[Similarity], trace: bool,
               converge: bool = True, trim_fraction: float = 0.0, scene_n=None,
               model_n=None, guard: bool = False):
    dt, dev = scene.dtype, scene.device
    with span("icp.prologue", dev):
        model, scene, mask = bucket_prologue(model, scene, scene_n, model_n)
        loop = LoopState(bound, length, threshold, reference_compat, dev, converge, guard)
        step_kw = loop.step_kw(with_scale)
        on_k2 = solver == "qcp_fused" and nn_method == "pallas"  # K2 keeps the state
        fused = fused_path_available(solver, nn_method, trim_fraction, model,
                                     masked=mask is not None)
        if fused:
            prep = prepare_fused_inputs(scene, model)
        else:
            p = scene if init is None else apply_similarity(scene, init)
        if on_k2:
            state = identity_state(dev) if init is None else pack_total_state(init, dev)
        else:
            total = identity_similarity(dt, dev) if init is None else init
    if fused:
        loop.run(lambda: fused_icp_step(prep, state, loop.ctl, loop.errs, **step_kw))
        with span("icp.finish", dev):
            total = Similarity(*(v.to(dt) for v in unpack_state(state)[1]))
            return loop.finish(apply_similarity(scene, total), total, dt, trace)

    if on_k2:
        def step():
            nonlocal p
            y = model[closest_point_indices(p, model, method=nn_method).to(torch.int64)]
            w = step_weights(p, y, trim_fraction, mask)
            stats = compute_alignment_stats(p, y, acc_dtype=torch.float64, weights=w)
            qcp_step(pack_stats(stats), state, loop.ctl, loop.errs, **step_kw)
            p = apply_similarity(p, step_similarity(state, dt))

        loop.run(step)
        with span("icp.finish", dev):
            total = Similarity(*(v.to(dt) for v in unpack_state(state)[1]))
            return loop.finish(p, total, dt, trace)

    def step():
        nonlocal p, total
        if loop.done():
            return
        p, sim, err_sum, n = _plain_step(p, model, solver=solver, nn_method=nn_method,
                                         with_scale=with_scale,
                                         trim_fraction=trim_fraction, mask=mask)
        total = compose(total, sim)
        loop.record(err_sum, n)

    loop.run(step)
    with span("icp.finish", dev):
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


@in_full_float32
def icp(model, scene, config: Optional[ICPConfig] = None, *, trace: bool = False,
        guard=False, init: Optional[Similarity] = None, n_iters=None, scene_n=None,
        model_n=None, device=None):
    """Register ``scene`` onto ``model``, both (N, 3).

    Returns ``ICPResult`` (or ``ICPTrace`` when ``trace=True``).  Runs on
    ``device`` when given, else on the device of the tensors given, else
    (numpy input) on the card; ``device="cpu"`` is the way onto the CPU.
    ``init``: warm-start Similarity (the returned
    transform still maps the caller's scene).  ``guard=True``: host-side
    NaN/Inf check of the result.  ``guard="device"``: also the status word
    in the loop (K2's, or its mirrors on the plain paths), which stops it
    on a non-finite or >100x-diverged error and raises ``ICPGuardError``
    with the failing iteration; as in JAX the grid and trace paths get the
    host check only.  ``n_iters``: an early-exit bound at most
    ``config.max_iter``, for plain runs.  ``scene_n`` / ``model_n``: valid
    row counts of bucket-padded clouds (``ops/padding.py``);
    ``result.points`` keeps the padded shape, slice ``[:scene_n]``.
    """
    where = model if device is None else device
    with register():
        with span("icp.prologue", where):
            cfg = config or ICPConfig()
            if n_iters is not None and (trace or guard):
                raise ValueError("n_iters is for plain runs; trace/guard paths "
                                 "size buffers by config.max_iter")
            if n_iters is not None and int(n_iters) > cfg.max_iter:
                raise ValueError(
                    f"n_iters={int(n_iters)} exceeds config.max_iter={cfg.max_iter}; "
                    "n_iters is an early-exit bound, not a replacement "
                    "(use ICPConfig(max_iter=...) or icp_fixed_iters)")
            if guard not in (False, True, "device"):
                raise ValueError(f"guard must be False, True or 'device', got {guard!r}")
            model = as_points(model, cfg.dtype, device)
            scene = as_points(scene, cfg.dtype, model.device)
            _validate(model, scene, cfg)
            backend = scene.device.type
            if init is not None:
                init = cast_similarity(init, cfg.dtype, scene.device)
            n_points = max(true_count(model.shape[0], model_n),
                           true_count(scene.shape[0], scene_n))
            nn_method = cfg.resolved_nn_method(backend, n_points)
            solver = cfg.resolved_solver(backend)
            bound = cfg.max_iter if n_iters is None else int(n_iters)
            kw = dict(threshold=cfg.threshold, bound=bound, length=cfg.max_iter,
                      solver=solver, with_scale=cfg.with_scale,
                      reference_compat=cfg.reference_compat, init=init, trace=trace,
                      trim_fraction=cfg.trim_fraction, scene_n=scene_n, model_n=model_n)
        if nn_method == "grid":
            from icp_tpu_torch.engine.grid import _icp_grid

            out = _icp_grid(model, scene, scene_tile_target=cfg.grid_scene_tile,
                            model_tile_target=cfg.grid_model_tile,
                            max_candidates=cfg.grid_max_candidates, **kw)
        else:
            out = _icp_dense(model, scene, nn_method=nn_method,
                             guard=guard == "device" and not trace, **kw)
        if guard:
            with span("icp.finish", scene):
                result = out.result if trace else out
                check_finite("icp", result.err, result.points)
        return out


@in_full_float32
def icp_fixed_iters(model, scene, *, n_iters: int, solver: str = "eigh",
                    nn_method: str = "bcast", with_scale: bool = True,
                    reference_compat: bool = True, trim_fraction: float = 0.0,
                    scene_n=None, model_n=None, device=None) -> ICPResult:
    """Exactly ``n_iters`` float32 iterations with no convergence exit (the
    benchmark workload, JAX's ``fori_loop``): a NaN or any other error does
    not stop it.  ``nn_method="grid"`` runs the grid engine with
    ``ICPConfig``'s default tiles.  Trim and bucket counts as in ``icp``;
    devices as in ``icp``."""
    where = model if device is None else device
    with register():
        with span("icp.prologue", where):
            model = as_points(model, torch.float32, device)
            scene = as_points(scene, torch.float32, model.device)
            kw = dict(threshold=-math.inf, bound=n_iters, length=n_iters, solver=solver,
                      with_scale=with_scale, reference_compat=reference_compat,
                      init=None, trace=False, converge=False, trim_fraction=trim_fraction,
                      scene_n=scene_n, model_n=model_n)
        if nn_method == "grid":
            from icp_tpu_torch.engine.grid import _icp_grid

            return _icp_grid(model, scene, **kw)
        return _icp_dense(model, scene, nn_method=nn_method, **kw)


def icp_resumable(model, scene, config: Optional[ICPConfig] = None, *,
                  checkpoint_path: str, checkpoint_every: int = 50, resume: bool = False,
                  init: Optional[Similarity] = None, device=None) -> ICPResult:
    """ICP in chunks of ``checkpoint_every`` iterations, saving ``(transform,
    total iterations, err)`` after each (``utils/checkpoint.py``); each
    chunk warm-starts from the cumulative transform (the first from an
    explicit identity), so a run resumed from the file (``resume=True``)
    reproduces the uninterrupted chunked run bit for bit: the file keeps
    float64 views of the float32 state, an exact round trip.  A run
    resumed past ``max_iter`` re-applies the stored transform and keeps the
    stored error."""
    from icp_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    cfg = config or ICPConfig()
    total_iters = 0
    cur = init
    loaded_err = math.nan
    if resume and os.path.exists(checkpoint_path):
        cur, total_iters, loaded_err, _ = load_checkpoint(checkpoint_path)
    chunk_cfg = dataclasses.replace(cfg, max_iter=min(checkpoint_every, cfg.max_iter))
    if cur is None:
        cur = identity_similarity(cfg.dtype)
    res = None
    while total_iters < cfg.max_iter:
        k = min(checkpoint_every, cfg.max_iter - total_iters)
        res = icp(model, scene, chunk_cfg, init=cur, n_iters=k, device=device)
        cur = res.transform
        total_iters += int(res.iters)
        save_checkpoint(checkpoint_path, transform=cur, iteration=total_iters,
                        err=float(res.err))
        if int(res.iters) < k or float(res.err) < cfg.threshold:
            break
    if res is None:
        pts = as_points(scene, cfg.dtype, device)
        cur = cast_similarity(cur, cfg.dtype, pts.device)
        return ICPResult(points=apply_similarity(pts, cur), transform=cur,
                         err=torch.tensor(loaded_err, dtype=cfg.dtype, device=pts.device),
                         iters=torch.tensor(total_iters, dtype=torch.int32))
    return ICPResult(points=res.points, transform=res.transform, err=res.err,
                     iters=torch.tensor(total_iters, dtype=torch.int32))
