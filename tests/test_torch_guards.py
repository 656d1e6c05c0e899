"""Failure detection in the port against the JAX package
(``tests/test_guards.py``).

  * ``guard="device"``: a clean run is bit-equal to the unguarded one; a
    NaN coordinate stops the loop at iteration 1 with ``ICPGuardError``
    ("non-finite") on the plain path, the fused path (K3's plain version,
    its last block's step) and the pipeline (K1 + K2, trimmed), as JAX's
    ``_icp_while_guarded``; the grid path gets the host check, as in JAX.
  * The status word: K2's plain step on a sequence of partial sums whose
    error jumps more than 100x above the least so far at step 2 raises the
    done flag with status 2 there (1 on a NaN row), and the host mirror
    (``LoopState.record``, ``record_error``) gives the same control words;
    so does the tensor-op mirror (``LoopState.record_on_device``) unguarded.
  * ``checked_icp_step`` names the first op that made a NaN, or an index
    out of range (clamped, as JAX's gather).
"""

import math

import numpy as np
import pytest
import torch

import icp_tpu
from icp_tpu.engine.icp import ICPGuardError as JGuardError
from icp_tpu_torch import ICPConfig, icp
from icp_tpu_torch.engine.icp import ICPGuardError, LoopState
from icp_tpu_torch.kernels import qcp
from icp_tpu_torch.ops.alignment import compute_alignment_stats
from icp_tpu_torch.utils.guards import _Checks, checked_icp_step
from tests.test_torch_faults import _pair

# (solver, NN, trim): the plain path, the fused path, the pipeline
PATHS = [("eigh", "bcast", 0.0), ("qcp_fused", "pallas", 0.0), ("qcp_fused", "pallas", 0.1)]
IDS = ["plain", "fused", "pipeline"]


@pytest.mark.parametrize("solver,nn,trim", PATHS, ids=IDS)
def test_device_guard_clean_run_unaffected(cow_pair, solver, nn, trim):
    ref, tr1 = cow_pair
    cfg = ICPConfig(max_iter=30, solver=solver, nn_method=nn, trim_fraction=trim)
    plain = icp(ref, tr1, cfg, device="cpu")
    guarded = icp(ref, tr1, cfg, guard="device", device="cpu")
    assert int(guarded.iters) == int(plain.iters)
    assert torch.equal(guarded.points, plain.points) and torch.equal(guarded.err, plain.err)


@pytest.mark.parametrize("solver,nn,trim", PATHS, ids=IDS)
def test_device_guard_nan_fails_fast(cow_pair, solver, nn, trim):
    ref, tr1 = cow_pair
    poisoned = np.asarray(tr1).copy()
    poisoned[7, 1] = np.nan
    cfg = ICPConfig(max_iter=30, solver=solver, nn_method=nn, trim_fraction=trim)
    with pytest.raises(ICPGuardError, match="non-finite error at iteration 1 ") as got:
        icp(ref, poisoned, cfg, guard="device", device="cpu")
    if solver == "eigh":  # JAX's message, word for word
        with pytest.raises(JGuardError) as want:
            icp_tpu.icp(ref, poisoned, icp_tpu.ICPConfig(max_iter=30, solver="eigh",
                                                         nn_method="bcast"), guard="device")
        assert str(got.value) == str(want.value)


def test_host_guard_still_catches_nan(cow_pair):
    ref, tr1 = cow_pair
    poisoned = np.asarray(tr1).copy()
    poisoned[0, 0] = np.inf
    with pytest.raises(FloatingPointError):
        icp(ref, poisoned, ICPConfig(max_iter=30), guard=True, device="cpu")


def test_grid_and_trace_paths_get_the_host_check():
    """As JAX (``icp_tpu/engine/icp.py:705-711``): no status word there, the
    host check raises ``FloatingPointError`` instead."""
    model, scene = _pair(n=300)
    cfg = ICPConfig(max_iter=10, solver="qcp_fused", nn_method="grid")
    with pytest.raises(FloatingPointError):
        icp(model, scene, cfg, guard="device", device="cpu")
    with pytest.raises(FloatingPointError):
        icp(model, scene, ICPConfig(max_iter=10), guard="device", trace=True, device="cpu")


def _partials(seed, sigma, n=200):
    """One (1, 18) row of float64 sums of a cloud and its copy moved by
    Gaussian noise of ``sigma``."""
    rng = np.random.default_rng(seed)
    p = torch.tensor(rng.standard_normal((n, 3)))
    y = p + sigma * torch.tensor(rng.standard_normal((n, 3)))
    return qcp.pack_stats(compute_alignment_stats(p, y))


def _run_plain(rows, guard=True):
    state, ctl, errs = qcp.identity_state(), qcp.new_loop_control(8), qcp.new_err_buffer(8)
    words = []
    for r in rows:
        qcp.qcp_step_plain(r, state, ctl, errs, with_scale=False, err_factor=1.0,
                           threshold=-math.inf, guard=guard)
        words.append(ctl.tolist())
    return words, errs, state


def test_k2_plain_status_word_on_a_diverging_sequence():
    rows = [_partials(s, sig) for s, sig in enumerate((0.05, 0.03, 0.6, 0.01))]
    words, errs, state = _run_plain(rows)
    e = errs[:3].tolist()
    assert e[2] > qcp.DIVERGE_FACTOR * min(e[:2]) and e[1] < e[0]
    assert words[:3] == [[1, 0, 8, 0], [2, 0, 8, 0], [3, 1, 8, qcp.GUARD_DIVERGED]]
    assert words[3] == words[2]  # done: nothing changes
    assert float(state[0, qcp.BEST_SLOT]) == e[1]
    unguarded, _, ustate = _run_plain(rows, guard=False)
    assert [w[:2] for w in unguarded] == [[1, 0], [2, 0], [3, 0], [4, 0]]
    assert all(w[3] == 0 for w in unguarded) and float(ustate[0, qcp.BEST_SLOT]) == 0.0
    nan_row = rows[1].clone()
    nan_row[0, 3] = float("nan")
    words, _, _ = _run_plain([rows[0], nan_row])
    assert words[1] == [2, 1, 8, qcp.GUARD_NONFINITE]


@pytest.mark.parametrize("on_device", [False, True], ids=["record", "record_on_device"])
def test_loop_mirrors_agree_with_the_k2_status(on_device):
    """The host mirror guarded, and the tensor-op mirror (the plane loops',
    which take no guard) unguarded, give K2's control words."""
    rows = [_partials(s, sig) for s, sig in enumerate((0.05, 0.03, 0.6, 0.01))]
    want, errs, _ = _run_plain(rows, guard=not on_device)
    loop = LoopState(8, 8, -math.inf, False, "cpu", guard=not on_device)
    got = []
    for e in errs[:4].tolist():
        if on_device:  # the gated loops call it after done too
            loop.record_on_device(torch.tensor(e, dtype=torch.float64))
        elif not loop.done():  # the host loop stops calling it
            loop.record(torch.tensor(e, dtype=torch.float64), torch.tensor(1.0))
        got.append(loop.ctl.tolist())
    assert got == want
    n = 4 if on_device else 3  # the guarded run stops at the third
    assert loop.errs[:n].tolist() == errs[:n].tolist()
    ctl, buf = qcp.new_loop_control(8), qcp.new_err_buffer(8)
    for e, w in zip(errs[:3].tolist(), want):
        best = min(errs[:max(0, int(ctl[0]))].tolist() + [math.inf])
        status = qcp.GUARD_OK if on_device else qcp.guard_status(e, best)
        qcp.record_error(ctl, buf, e, -math.inf, status=status)
        assert ctl.tolist() == w


def test_checked_step_locates_nan(cow_pair):
    ref, tr1 = cow_pair
    msg, out = checked_icp_step(tr1, ref, device="cpu")
    assert msg is None and math.isfinite(float(out[2]))  # clean input: no check fires
    poisoned = np.asarray(tr1).copy()
    poisoned[3, 2] = np.nan
    msg, _ = checked_icp_step(poisoned, ref, device="cpu")
    assert msg is not None and "nan" in msg.lower()


def test_checks_clamp_an_index_out_of_range():
    x = torch.arange(5.0)
    with _Checks() as checks:
        got = x[torch.tensor([1, 7])]
        picked = torch.index_select(x, 0, torch.tensor([9]))
    assert checks.msg is not None and "out-of-bounds" in checks.msg
    assert got.tolist() == [1.0, 4.0] and picked.tolist() == [4.0]
