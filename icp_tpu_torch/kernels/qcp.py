"""K2: the scalar alignment step and K5: the rotation solve
(``csrc/qcp.cu``), and the state block.

Port of ``icp_tpu/kernels/qcp_pallas.py``.  The (1, 32) state block keeps
the JAX layout (``qcp_pallas.py:91-119``) in float64::

    [s_step, R_step (9, row major), t_step (3),
     s_tot, R_tot (9), t_tot (3), residual_sum, lambda, best, 0, 0, 0]

K2 (one warp, ``csrc/qcp_warp.cuh``; the fused dense iteration K3 runs the
same step in its last block) reads a (P, 18) float64 array of partial
sums — rows of
``[sum_py (9), sum_p (3), sum_y (3), sum_pp, sum_yy, n]`` added in row
order — and updates the state block, the loop control and the error buffer
in place: it solves the step, composes it onto the cumulative transform,
writes ``errs[it] = err_factor * residual / n``, advances the iteration
count and raises the done flag when the bound is reached or, in
convergence mode (``converge=True``, ``icp``), when ``not err >=
threshold`` (a NaN error stops it too); in fixed mode (``converge=False``,
``icp_fixed_iters``) only the bound does.  With ``guard=True``
(``icp(guard="device")``, JAX's ``_icp_while_guarded``) the flag also
rises when the error is not finite (status 1) or exceeds
``DIVERGE_FACTOR`` times the least error so far (status 2); the step keeps
that least error in slot ``best`` (28, read as +inf at iteration 0, so the
block keeps the JAX layout; an unguarded step writes 0 there) and writes
the status into ``ctl[3]``.  Once done, it
writes the identity step and returns.

Loop control ``ctl``: int32 ``[iterations done, done flag, bound, guard
status]``.

K5 (``qcp_rotation``) is the rotation-only solve of the same scalar math
(``_qcp_kernel``), on the JAX kernel's (1, 16) slots in float64::

    in:  [S (9, row major), gp, gy, 0, 0, 0, 0, 0]
    out: [R (9, row major), q (4: w, x, y, z), lambda, 0, 0]

``qcp_rotation_from(S, gp, gy)`` is the same launch on S, gp and gy as the
caller holds them (float32 or float64), with no packing on the host: it
returns (R in S's dtype, q, lambda), as ``horn_rotation_pallas`` does.

``qcp_step_plain`` and ``qcp_rotation_plain`` are the same functions in
plain Python floats, in the same operation order; the wrappers take them
only for CPU tensors.

The pair axis (the counterpart of JAX's ``vmap`` over the ``pallas_call``):
``qcp_step`` also takes B pairs at once, partials (B, P, 18), states
(B, 32), controls (B, 4) and error buffers (B, L), and ``qcp_rotation`` /
``qcp_rotation_from`` take (B, 16) blocks / (B, 3, 3) S with (B,) gp and
gy; on the card each is one launch of one warp a pair, every pair's output
bit-equal to its own single-pair launch (the single pair is B = 1).  Their
plain versions run the single-pair plain version pair by pair.
"""

from __future__ import annotations

import math

import torch

from icp_tpu_torch.kernels import _build
from icp_tpu_torch.ops.alignment import AlignmentStats, Similarity
from icp_tpu_torch.utils.profiling import host_wait

N_SUMS = 18
STATE_SLOTS = 32
BEST_SLOT = 28  # the guard's least error so far
CTL_SLOTS = 4
ROT_SLOTS = 16
# err > DIVERGE_FACTOR * best aborts a guarded loop (JAX's _DIVERGE_FACTOR):
# loose on purpose, it catches blow-ups, not plateaus
DIVERGE_FACTOR = 100.0
GUARD_OK, GUARD_NONFINITE, GUARD_DIVERGED = 0, 1, 2
_ROT_DTYPES = (torch.float32, torch.float64)  # qcp_rotation_from's input types
_NEWTON_ITERS = 12
_POWER_ITERS = 2


def identity_state(device=None, pairs: int = 1) -> torch.Tensor:
    """(pairs, 32) float64 state blocks of the identity cumulative transform
    (one block, (1, 32), by default)."""
    out = torch.zeros((pairs, STATE_SLOTS), dtype=torch.float64, device=device)
    with host_wait():  # the index list's copy from the host waits for the stream
        out[:, [13, 14, 18, 22]] = 1.0  # s_tot, R_tot diagonal
    return out


def pack_total_state(sim: Similarity, device=None) -> torch.Tensor:
    """(1, 32) state block whose cumulative transform is ``sim`` (warm start)."""
    s, R, t = (torch.as_tensor(v).to(dtype=torch.float64, device=device)
               for v in sim)
    out = torch.zeros((1, STATE_SLOTS), dtype=torch.float64, device=device)
    out[0, 13] = s
    out[0, 14:23] = R.reshape(-1)
    out[0, 23:26] = t
    return out


def unpack_state(state: torch.Tensor):
    """(step Similarity, total Similarity, residual_sum) of a state block."""
    step = Similarity(s=state[0, 0], R=state[0, 1:10].reshape(3, 3),
                      t=state[0, 10:13])
    total = Similarity(s=state[0, 13], R=state[0, 14:23].reshape(3, 3),
                       t=state[0, 23:26])
    return step, total, state[0, 26]


def unpack_states(states: torch.Tensor):
    """(step Similarity, total Similarity) of (B, 32) state blocks, each
    field with the pair axis first."""
    step = Similarity(s=states[:, 0], R=states[:, 1:10].reshape(-1, 3, 3), t=states[:, 10:13])
    total = Similarity(s=states[:, 13], R=states[:, 14:23].reshape(-1, 3, 3),
                       t=states[:, 23:26])
    return step, total


def pack_stats(stats: AlignmentStats) -> torch.Tensor:
    """AlignmentStats -> one (1, 18) float64 row of partial sums; with
    leading pair axes (B,), one such row a pair: (B, 1, 18)."""
    dt = torch.float64
    lead = tuple(stats.n.shape)
    return torch.cat([
        stats.sum_py.to(dt).reshape(*lead, 9), stats.sum_p.to(dt), stats.sum_y.to(dt),
        stats.sum_pp.to(dt).reshape(*lead, 1), stats.sum_yy.to(dt).reshape(*lead, 1),
        stats.n.to(dt).reshape(*lead, 1),
    ], -1).reshape(*lead, 1, N_SUMS)


def new_loop_control(bound: int, device=None, pairs=None) -> torch.Tensor:
    """ctl = [0, done, bound, status 0]; done from the start when the bound
    is 0.  ``pairs``: one such row a pair, (pairs, 4)."""
    with host_wait():  # a copy from the host waits for the stream
        ctl = torch.tensor([0, int(bound <= 0), bound, GUARD_OK], dtype=torch.int32,
                           device=device)
    return ctl if pairs is None else ctl.repeat(pairs, 1)


def new_err_buffer(length: int, device=None, pairs=None) -> torch.Tensor:
    """NaN error buffer (length,), or (pairs, length)."""
    shape = (length,) if pairs is None else (pairs, length)
    return torch.full(shape, float("nan"), dtype=torch.float64, device=device)


def qcp_step(partials: torch.Tensor, state: torch.Tensor, ctl: torch.Tensor,
             errs: torch.Tensor, *, with_scale: bool = True,
             threshold: float = -math.inf, err_factor: float = 2.0,
             converge: bool = True, guard: bool = False) -> None:
    """One alignment step, in place on ``state``, ``ctl`` and ``errs``: one
    pair's (partials (P, 18), state (1, 32), ctl (4,), errs (L,)) or, with
    the pair axis, B pairs' (partials (B, P, 18), states (B, 32), controls
    (B, 4), error buffers (B, L)), one launch for all of them."""
    pairs = _check(partials, state, ctl, errs)
    if partials.device.type == "cpu":
        qcp_step_plain(partials, state, ctl, errs, with_scale=with_scale,
                       threshold=threshold, err_factor=err_factor, converge=converge,
                       guard=guard)
        return
    if not pairs:
        return
    code = _build.lib().qcp_step_launch(
        partials.data_ptr(), pairs, partials.shape[-2], state.data_ptr(),
        ctl.data_ptr(), errs.data_ptr(), errs.shape[-1], int(with_scale), float(threshold),
        float(err_factor), int(converge), int(guard), _build.stream_ptr(partials))
    _build.LAUNCHES["qcp_step"] += 1
    _build.check(code, "qcp_step")


def _check(partials, state, ctl, errs) -> int:
    """Raise unless the step's tensors are one pair's or B pairs'; returns
    the number of pairs."""
    dev = partials.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"qcp_step: unsupported device {dev}")
    for name, t, dt in (("partials", partials, torch.float64),
                        ("state", state, torch.float64),
                        ("ctl", ctl, torch.int32), ("errs", errs, torch.float64)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"qcp_step: {name} must be a contiguous {dt} "
                             f"tensor on {dev} (got {t.dtype} on {t.device})")
    if ctl.ndim == 2:  # the pair axis
        b = ctl.shape[0]
        if partials.ndim != 3 or partials.shape[0] != b or partials.shape[2] != N_SUMS \
                or partials.shape[1] < 1:
            raise ValueError(f"qcp_step: partials must be ({b}, P, {N_SUMS}), got "
                             f"{tuple(partials.shape)}")
        if state.shape != (b, STATE_SLOTS) or ctl.shape != (b, CTL_SLOTS) \
                or errs.ndim != 2 or errs.shape[0] != b:
            raise ValueError(f"qcp_step: states must be ({b}, 32), controls ({b}, "
                             f"{CTL_SLOTS}) and error buffers ({b}, L)")
        return b
    if partials.ndim != 2 or partials.shape[1] != N_SUMS or partials.shape[0] < 1:
        raise ValueError(f"qcp_step: partials must be (P, {N_SUMS}), got "
                         f"{tuple(partials.shape)}")
    if state.shape != (1, STATE_SLOTS) or ctl.shape != (CTL_SLOTS,) or errs.ndim != 1:
        raise ValueError(f"qcp_step: state must be (1, 32), ctl ({CTL_SLOTS},) and errs (L,)")
    return 1


def guard_status(err: float, best: float) -> int:
    """The guard's status word for ``err`` given the least error so far:
    non-finite, diverged (``err > DIVERGE_FACTOR * best``) or ok."""
    if not math.isfinite(err):
        return GUARD_NONFINITE
    return GUARD_DIVERGED if err > DIVERGE_FACTOR * best else GUARD_OK


def least(err: float, best: float) -> float:
    """The guard's least error so far after ``err`` (K2's ``err < best``)."""
    return err if err < best else best


def record_error(ctl: torch.Tensor, errs: torch.Tensor, err: float,
                 threshold: float, converge: bool = True, status: int = GUARD_OK) -> None:
    """The loop bookkeeping of K2, on the host: errs[it] = err, it += 1, and
    done when the bound is reached, (``converge``) ``not err >=
    threshold``, or the guard's ``status`` is not ok (written to ctl[3])."""
    it, _, bound, old = ctl.tolist()
    errs[it] = err
    done = int(it + 1 >= bound or (converge and not err >= threshold) or status != GUARD_OK)
    ctl.copy_(torch.tensor([it + 1, done, bound, status or old], dtype=torch.int32))


def qcp_step_plain(partials, state, ctl, errs, *, with_scale=True,
                   threshold=-math.inf, err_factor=2.0, converge=True, guard=False) -> None:
    """Plain version of K2 (same operation order, Python float64); with the
    pair axis, pair by pair."""
    if ctl.ndim == 2:
        for b in range(ctl.shape[0]):
            qcp_step_plain(partials[b], state[b:b + 1], ctl[b], errs[b],
                           with_scale=with_scale, threshold=threshold,
                           err_factor=err_factor, converge=converge, guard=guard)
        return
    if int(ctl[1]):
        step = [1.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0]
        state[0, :13] = torch.tensor(step, dtype=torch.float64)
        return
    a = [0.0] * N_SUMS
    for row in partials.tolist():
        for k in range(N_SUMS):
            a[k] += row[k]
    prev = state[0].tolist()
    out, resid, n = _alignment_update(a, prev, with_scale)
    err = _div(err_factor * resid, n)
    best = math.inf if int(ctl[0]) == 0 else prev[BEST_SLOT]
    status = guard_status(err, best) if guard else GUARD_OK
    if guard:
        out[BEST_SLOT] = least(err, best)
    state.copy_(torch.tensor([out], dtype=torch.float64))
    record_error(ctl, errs, err, threshold, converge, status)


def _div(a: float, b: float) -> float:
    """a / b with the kernel's IEEE result for b == 0 (a signed infinity,
    or NaN for 0 / 0), where Python raises: a trimmed or masked step whose
    weights are all 0 has n = 0."""
    if b != 0.0:
        return a / b
    if a != a or a == 0.0:
        return math.nan
    return math.copysign(math.inf, a) * math.copysign(1.0, b)


def _mx(a: float, b: float) -> float:
    """max that lets a NaN in ``a`` through (as jnp.maximum does)."""
    return b if a < b else a


def _minor3(M, r, c) -> float:
    (r0, r1, r2), (c0, c1, c2) = r, c
    return (M[r0][c0] * (M[r1][c1] * M[r2][c2] - M[r1][c2] * M[r2][c1])
            - M[r0][c1] * (M[r1][c0] * M[r2][c2] - M[r1][c2] * M[r2][c0])
            + M[r0][c2] * (M[r1][c0] * M[r2][c1] - M[r1][c1] * M[r2][c0]))


def _others(skip: int):
    return tuple(x for x in range(4) if x != skip)


def _qcp_rotation(S, gp, gy):
    """(R, unit quaternion q, lambda_max) from the centred cross-covariance;
    the solve runs on S / (gp + gy) and lambda is un-scaled
    (``qcp_pallas.py:143-240``)."""
    total = _mx(gp + gy, 1e-30)
    norm = 1.0 / total
    S = [[S[r][c] * norm for c in range(3)] for r in range(3)]
    gp = gp * norm
    gy = gy * norm
    (S00, S01, S02), (S10, S11, S12), (S20, S21, S22) = S
    tr = S00 + S11 + S22
    A, B, C = S12 - S21, S20 - S02, S01 - S10
    N = [
        [tr, A, B, C],
        [A, S00 - S11 - S22, S01 + S10, S02 + S20],
        [B, S01 + S10, S11 - S00 - S22, S12 + S21],
        [C, S02 + S20, S12 + S21, S22 - S00 - S11],
    ]
    c2 = -2.0 * (S00 * S00 + S01 * S01 + S02 * S02 + S10 * S10 + S11 * S11
                 + S12 * S12 + S20 * S20 + S21 * S21 + S22 * S22)
    detS = (S00 * (S11 * S22 - S12 * S21) - S01 * (S10 * S22 - S12 * S20)
            + S02 * (S10 * S21 - S11 * S20))
    c1 = -8.0 * detS
    c0 = 0.0
    for j in range(4):
        sgn = -1.0 if j % 2 else 1.0
        c0 = c0 + (sgn * N[0][j]) * _minor3(N, (1, 2, 3), _others(j))
    lam = math.sqrt(_mx(gp * gy, 0.0))
    for _ in range(_NEWTON_ITERS):
        p = ((lam * lam + c2) * lam + c1) * lam + c0
        dp = (4.0 * lam * lam + 2.0 * c2) * lam + c1
        dp = 1.0 if abs(dp) < 1e-30 else dp
        lam = lam - p / dp
    M = [[N[i][j] - lam if i == j else N[i][j] for j in range(4)] for i in range(4)]
    adj = [[0.0] * 4 for _ in range(4)]
    for i in range(4):
        for j in range(4):
            sgn = -1.0 if (i + j) % 2 else 1.0
            adj[j][i] = sgn * _minor3(M, _others(i), _others(j))
    best, q = 0.0, [0.0] * 4
    for j in range(4):
        nj = adj[0][j] * adj[0][j] + adj[1][j] * adj[1][j] + adj[2][j] * adj[2][j] \
            + adj[3][j] * adj[3][j]
        if j == 0 or nj > best:
            best, q = nj, [adj[k][j] for k in range(4)]
    if best < 1e-16:  # degenerate adjugate: all-ones seed
        q = [1.0] * 4
    shift = math.sqrt(_mx(gp * gy, 0.0)) + 1.0
    for _ in range(_POWER_ITERS):
        w = [N[i][0] * q[0] + N[i][1] * q[1] + N[i][2] * q[2] + N[i][3] * q[3]
             + shift * q[i] for i in range(4)]
        inv = 1.0 / math.sqrt(_mx(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
                                  + w[3] * w[3], 1e-30))
        q = [wi * inv for wi in w]
    inv = 1.0 / math.sqrt(_mx(q[0] * q[0] + q[1] * q[1] + q[2] * q[2]
                              + q[3] * q[3], 1e-30))
    w_, x_, y_, z_ = (qk * inv for qk in q)
    R = [
        [w_ * w_ + x_ * x_ - y_ * y_ - z_ * z_, 2.0 * (x_ * y_ - w_ * z_),
         2.0 * (x_ * z_ + w_ * y_)],
        [2.0 * (x_ * y_ + w_ * z_), w_ * w_ - x_ * x_ + y_ * y_ - z_ * z_,
         2.0 * (y_ * z_ - w_ * x_)],
        [2.0 * (x_ * z_ - w_ * y_), 2.0 * (y_ * z_ + w_ * x_),
         w_ * w_ - x_ * x_ - y_ * y_ + z_ * z_],
    ]
    return R, [w_, x_, y_, z_], lam * total


def _alignment_update(a, prev, with_scale):
    """(new 32-slot state, residual_sum, n) from the 18 summed statistics
    and the previous state (``alignment_update_scalars``, qcp_pallas.py:47)."""
    n = a[17]
    inv_n = _div(1.0, n)
    mu_p = [a[9 + k] * inv_n for k in range(3)]
    mu_y = [a[12 + k] * inv_n for k in range(3)]
    S = [[a[3 * r + c] - n * mu_p[r] * mu_y[c] for c in range(3)] for r in range(3)]
    gp = a[15] - n * (mu_p[0] * mu_p[0] + mu_p[1] * mu_p[1] + mu_p[2] * mu_p[2])
    gy = a[16] - n * (mu_y[0] * mu_y[0] + mu_y[1] * mu_y[1] + mu_y[2] * mu_y[2])
    R, _, lam = _qcp_rotation(S, gp, gy)
    s = math.sqrt(_mx(gy / _mx(gp, 1e-30), 0.0)) if with_scale else 1.0
    t = [mu_y[r] - s * (R[r][0] * mu_p[0] + R[r][1] * mu_p[1] + R[r][2] * mu_p[2])
         for r in range(3)]
    resid = _mx(gy + s * s * gp - 2.0 * s * lam, 0.0)
    prev_s = prev[13]
    pR = [[prev[14 + 3 * r + c] for c in range(3)] for r in range(3)]
    pt = prev[23:26]
    out = [s, *(R[r][c] for r in range(3) for c in range(3)), *t, s * prev_s]
    out += [R[r][0] * pR[0][c] + R[r][1] * pR[1][c] + R[r][2] * pR[2][c]
            for r in range(3) for c in range(3)]
    out += [s * (R[r][0] * pt[0] + R[r][1] * pt[1] + R[r][2] * pt[2]) + t[r]
            for r in range(3)]
    out += [resid, lam, 0.0, 0.0, 0.0, 0.0]
    return out, resid, n


def step_similarity(state: torch.Tensor, dtype) -> Similarity:
    """The state's step transform as a Similarity of ``dtype``."""
    step, _, _ = unpack_state(state)
    return Similarity(*(v.to(dtype) for v in step))


def pack_rotation_input(S: torch.Tensor, gp: torch.Tensor,
                        gy: torch.Tensor) -> torch.Tensor:
    """K5's (1, 16) float64 input block from S (3, 3), gp and gy."""
    dt = torch.float64
    return torch.cat([S.to(dt).reshape(-1), gp.to(dt).reshape(1), gy.to(dt).reshape(1),
                      torch.zeros(5, dtype=dt, device=S.device)]).reshape(1, ROT_SLOTS)


def qcp_rotation(packed: torch.Tensor) -> torch.Tensor:
    """K5: the (B, 16) output blocks [R, q, lambda, 0, 0] of (B, 16) input
    blocks [S, gp, gy, 0...], float64 (JAX's (1, 16) is B = 1); one launch
    for all the blocks."""
    dev = packed.device
    if packed.ndim != 2 or packed.shape[1] != ROT_SLOTS or packed.dtype != torch.float64 \
            or not packed.is_contiguous() or dev.type not in ("cpu", "cuda"):
        raise ValueError(f"qcp_rotation: input must be a contiguous float64 "
                         f"(B, {ROT_SLOTS}) tensor, got {packed.dtype} "
                         f"{tuple(packed.shape)} on {dev}")
    if dev.type == "cpu":
        return qcp_rotation_plain(packed)
    out = torch.empty(packed.shape, dtype=torch.float64, device=dev)
    if packed.shape[0]:
        code = _build.lib().qcp_rotation_launch(packed.data_ptr(), packed.shape[0],
                                                out.data_ptr(), _build.stream_ptr(packed))
        _build.LAUNCHES["qcp_rotation"] += 1
        _build.check(code, "qcp_rotation")
    return out


def qcp_rotation_from(S: torch.Tensor, gp: torch.Tensor, gy: torch.Tensor):
    """K5 from the centred cross-covariance S (3, 3, contiguous) and the
    energies gp and gy (one element each), all float32 or all float64, as
    ``horn_rotation_pallas(S, gp, gy)``: (R (3, 3) in S's dtype, q (4,)
    float64 (w, x, y, z), lambda () float64).  The kernel widens the inputs
    to float64 exactly (as ``.to(float64)``) and rounds R back to S's dtype
    as ``.to`` does; q and lambda are views of its (1, 16) block, and a
    float32 R shares the block's allocation.  With the pair axis, S (B, 3,
    3) and gp, gy of B contiguous elements: R (B, 3, 3), q (B, 4) and
    lambda (B,), one launch for all the pairs."""
    dt, dev = S.dtype, S.device
    b = S.shape[0] if S.ndim == 3 else None
    k = 1 if b is None else b
    if (S.shape[-2:] != (3, 3) or S.ndim not in (2, 3) or dt not in _ROT_DTYPES
            or not S.is_contiguous() or gp.dtype != dt or gy.dtype != dt
            or gp.numel() != k or gy.numel() != k
            or (b is not None and not (gp.is_contiguous() and gy.is_contiguous()))
            or gp.device != dev or gy.device != dev or dev.type not in ("cpu", "cuda")):
        raise ValueError(f"qcp_rotation_from: S must be a contiguous (3, 3) or (B, 3, 3) "
                         f"float32 or float64 tensor and gp, gy one element (a contiguous B) "
                         f"each of its dtype and device; got S {dt} {tuple(S.shape)} on "
                         f"{dev}, gp {gp.dtype} {tuple(gp.shape)} on {gp.device}, gy "
                         f"{gy.dtype} {tuple(gy.shape)} on {gy.device}")
    if dev.type == "cpu":
        return qcp_rotation_from_plain(S, gp, gy)
    f64 = dt == torch.float64
    # [blocks (16 float64 each), R as 9 float32 a pair] in one allocation; a
    # float64 R is each block's first nine slots
    buf = torch.empty(ROT_SLOTS * k + (0 if f64 else -(-9 * k // 2)), dtype=torch.float64,
                      device=dev)
    shape = (3, 3) if b is None else (b, 3, 3)
    if f64:
        R = buf.as_strided(shape, (3, 1) if b is None else (ROT_SLOTS, 3, 1), 0)
    else:
        R = buf.view(torch.float32)[2 * ROT_SLOTS * k:2 * ROT_SLOTS * k + 9 * k].view(shape)
    if k:
        code = _build.lib().qcp_rotation_from_launch(
            S.data_ptr(), gp.data_ptr(), gy.data_ptr(), int(f64), k, buf.data_ptr(),
            None if f64 else R.data_ptr(), _build.stream_ptr(S))
        _build.LAUNCHES["qcp_rotation"] += 1
        _build.check(code, "qcp_rotation")
    if b is None:
        return R, buf.as_strided((4,), (1,), 9), buf.as_strided((), (), 13)
    return R, buf.as_strided((b, 4), (ROT_SLOTS, 1), 9), buf.as_strided((b,), (ROT_SLOTS,), 13)


def _rotation_block(S, gp: float, gy: float) -> list:
    """K5's 16 output slots [R, q, lambda, 0, 0] from S (3 x 3 floats)."""
    R, q, lam = _qcp_rotation(S, gp, gy)
    return [v for row in R for v in row] + q + [lam, 0.0, 0.0]


def qcp_rotation_plain(packed: torch.Tensor) -> torch.Tensor:
    """Plain version of K5 (Python float64, K2's operation order), block by
    block."""
    out = []
    for a in packed.tolist():
        S = [[a[3 * r + c] for c in range(3)] for r in range(3)]
        out.append(_rotation_block(S, a[9], a[10]))
    return torch.tensor(out, dtype=torch.float64, device=packed.device).reshape(packed.shape)


def qcp_rotation_from_plain(S: torch.Tensor, gp: torch.Tensor, gy: torch.Tensor):
    """Plain version of ``qcp_rotation_from``: the inputs read as Python
    floats (exact), K5's plain solve, R cast back to S's dtype; with the
    pair axis, pair by pair."""
    if S.ndim == 3:
        gps, gys = gp.reshape(-1).tolist(), gy.reshape(-1).tolist()
        out = torch.tensor([_rotation_block(s, g, y) for s, g, y in zip(S.tolist(), gps, gys)],
                           dtype=torch.float64, device=S.device).reshape(S.shape[0], ROT_SLOTS)
        return out[:, :9].reshape(-1, 3, 3).to(S.dtype), out[:, 9:13], out[:, 13]
    out = torch.tensor(_rotation_block(S.tolist(), float(gp), float(gy)),
                       dtype=torch.float64, device=S.device)
    return out[:9].reshape(3, 3).to(S.dtype), out[9:13], out[13]
