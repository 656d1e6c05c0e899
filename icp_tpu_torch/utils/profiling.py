"""Profiling, the program's spans and counters, and the host-side finite
check (port of ``icp_tpu/utils/profiling.py``; the spans and counters are
the port's own).

``trace(log_dir)`` records a ``torch.profiler`` trace of its body (the
card's kernels too when one is present) and writes it as a Chrome trace
(``trace.json``, for Perfetto or ``chrome://tracing``) into ``log_dir``,
with the counters of its body beside it (``counters.json``).  Where JAX's
``trace`` falls back to wall time when its profiler cannot start, this one
raises: a profiler that fails on the card is a fault to see, not to hide.

Spans and counters are on while a ``torch.profiler`` records, whoever
started it, and cost one flag check at each site otherwise: no span is
entered and no counter moves.  The spans are RecordFunction ranges (as
``record_function``'s) on the profiler's own clock, so a trace's idle gaps
fall inside the innermost of them.  One registration:

  ``icp.register``        a public single-pair entry (``icp``,
                          ``icp_fixed_iters``, ``icp_point_to_plane``,
                          ``icp_symmetric``, ``icp_generalized``); its
                          ``seq`` is the call's sequence number (in the
                          trace's args with ``record_shapes=True``)
  ``icp.prologue``        input casts and checks, the dispatch, the bucket
                          padding, the loop's buffers, K3's inputs
  ``icp.normals.knn``     the normals' neighbours (K6 or K7)
  ``icp.normals.pca``     the normals from them
  ``icp.setup.model_grid`` the model's kd grid (grid paths)
  ``icp.setup.scene_sort`` the scene's kd sort and tile padding
  ``icp.setup.seed``      the first bounds (K1 on a strided model)
  ``icp.loop``            ``LoopState.run``: every launched iteration
  ``icp.finish``          the final apply, the un-permute, the result
  ``icp.host_wait``       each blocking read of the device by the host
                          (``host_wait``), inside the spans above

Every span but ``icp.register`` and ``icp.host_wait`` is a phase: it also
records a pair of CUDA events on the current stream (the host clock for a
CPU run), read only when ``counters()`` is; ``icp.register``'s device range
runs from its first phase's start to its last phase's end.  The phases lie
side by side under ``icp.register``.  An inner span (``inner``) lies inside
a phase and records its events as a phase does, but its device ms go to
``inner_ms``, apart from ``phase_ms``, so that no sum over the phases counts
its time twice:

  ``icp.gicp.step``       inside ``icp.loop``, GICP's own work of each
                          launched iteration (``engine/gicp.py``): the
                          matched model rows' covariances, the Mahalanobis
                          system, its solve, the moved points and the
                          error; then the scene covariances' rotation: two
                          spans an iteration, never around K4 or the
                          loop's record and gating

Counters (``counters()``, each summed over the recorded calls):

  ``registrations``       ``icp.register`` spans entered
  ``host_waits``          ``host_wait`` reads
  ``iters_launched``      iterations ``LoopState.run`` launched
  ``iters_done``          iterations the results count (``result.iters``)
  ``k4_rows``, ``k4_items``, ``k4_items_skipped``, ``k4_table_pairs``,
  ``k4_pairs``, ``k4_tiles``, ``k4_tiles_past_cap``
                          K4's scene rows, its work items (each scene
                          tile's fold list, near pass included), those its
                          fold skipped (a count on the device), the (scene,
                          model row) pairs of all its items and of the
                          items it folded, its scene tiles and those past
                          the table's capacity (which fold every tile)
  ``k7_rows``, ``k7_pairs`` likewise for K7's two launches a kNN
  ``phase_ms``            {phase span: device ms of its ranges}
  ``inner_ms``            {inner span: device ms of its ranges}, present
                          only once an inner span has run

Counting adds no launch and no read while the profiler records: a counter
keeps the device tensors the program computes anyway (K4's and K7's tile
counts, K4's skipped items, the loop's iteration count) and reduces them
when ``counters()`` is read.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import time
from typing import Callable, Iterator

import torch

_profiler = torch.autograd.profiler
_OFF = contextlib.nullcontext()
# The spans' ranges: torch's C++ RecordFunction range, the one
# ``record_function`` opens, at a tenth of its host cost under the profiler
# (~0.8 against ~8.9 us a span; torch 2.13, CPU).
_range = torch._C._profiler._RecordFunctionFast

_ints: collections.Counter = collections.Counter()  # settled counts
_ms: collections.Counter = collections.Counter()  # settled phase ms
_later: list = []  # (fn, args): fn(*args) -> {counter: int}, reduced on read
_phases: list = []  # (name, start, end): CUDA events or host seconds, read on read
_inner_ms: collections.Counter = collections.Counter()  # settled inner span ms
_inner: list = []  # (name, start, end) of the inner spans, read on read
_roots: list = []  # the open icp.register spans, innermost last


class _Phase:
    """A span that also notes its duration on the device's timeline, and
    stretches the open ``icp.register``'s over it."""

    __slots__ = ("name", "where", "range", "stream", "start")

    def __init__(self, name: str, where):
        self.name, self.where = name, where

    def _mark(self):
        if self.stream is None:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def _open(self) -> None:
        self.range = _range(self.name)
        self.range.__enter__()
        dev = _device_of(self.where)
        self.stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        self.start = self._mark()

    def __enter__(self):
        self._open()
        if _roots and _roots[-1].start is None:
            _roots[-1].start = self.start
        return self

    def __exit__(self, *exc):
        end = self._mark()
        _phases.append((self.name, self.start, end))
        if _roots:
            _roots[-1].end = end
        return self.range.__exit__(*exc)


class _Inner(_Phase):
    """A span inside a phase: its marks go to ``inner_ms``, and the open
    ``icp.register``'s range is left as its phases make it."""

    __slots__ = ()

    def __enter__(self):
        self._open()
        return self

    def __exit__(self, *exc):
        _inner.append((self.name, self.start, self._mark()))
        return self.range.__exit__(*exc)


class _Register:
    """The root span: its range on the device runs from the start of its
    first phase to the end of its last, so it records no marks of its own
    (they would sit in the host time outside its phases)."""

    __slots__ = ("range", "start", "end")

    def __enter__(self):
        _ints["registrations"] += 1
        self.range = _range("icp.register", keyword_values={"seq": _ints["registrations"]})
        self.range.__enter__()
        self.start = self.end = None
        _roots.append(self)
        return self

    def __exit__(self, *exc):
        _roots.pop()
        if self.start is not None:
            _phases.append(("icp.register", self.start, self.end))
        return self.range.__exit__(*exc)


def _device_of(where) -> torch.device:
    """The device a phase runs on: ``where``'s (a tensor, device or device
    name), or the card when there is one (numpy input or None)."""
    if isinstance(where, torch.Tensor):
        return where.device
    if isinstance(where, (torch.device, str)):
        return torch.device(where)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def span(name: str, where=None):
    """The span ``name`` of a phase on ``where``'s device (``_device_of``)
    while the profiler records, else a shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Phase(name, where)


def inner(name: str, where=None):
    """The inner span ``name`` inside a phase, on ``where``'s device
    (``_device_of``), while the profiler records, else a shared no-op
    context; its device ms are counted in ``inner_ms``."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Inner(name, where)


def register():
    """The root span ``icp.register`` of one registration, its sequence
    number its ``seq``, counted in ``registrations``, while the profiler
    records, else a shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Register()


@contextlib.contextmanager
def _waiting() -> Iterator[None]:
    with _range("icp.host_wait"):
        _ints["host_waits"] += 1
        mode = torch.cuda.get_sync_debug_mode() if torch.cuda.is_initialized() else 0
        if mode:  # a counted wait is meant: the debug mode finds the others
            torch.cuda.set_sync_debug_mode(0)
        try:
            yield
        finally:
            if mode:
                torch.cuda.set_sync_debug_mode(mode)


def host_wait():
    """The context of a blocking device-to-host read (or a copy that waits
    for the stream): while the profiler records, an ``icp.host_wait`` span,
    counted in ``host_waits``, in which ``torch.cuda``'s sync debug mode
    is off; else a shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _waiting()


def count(name: str, value=1) -> None:
    """Add ``value`` (an int, or a 0-d integer tensor kept and read with
    ``counters()``) to counter ``name`` while the profiler records."""
    if not _profiler._is_profiler_enabled:
        return
    if isinstance(value, torch.Tensor):
        _later.append((_tensor_count, (name, value)))
    else:
        _ints[name] += value


def count_later(fn: Callable[..., dict], *args) -> None:
    """Add ``fn(*args)``'s {counter: int} when ``counters()`` is read, while
    the profiler records; ``args`` are kept until then."""
    if _profiler._is_profiler_enabled:
        _later.append((fn, args))


def _tensor_count(name: str, value: torch.Tensor) -> dict:
    return {name: int(value)}


def _elapsed_ms(start, end) -> float:
    if isinstance(start, float):
        return 1e3 * (end - start)
    end.synchronize()
    return start.elapsed_time(end)


def counters() -> dict:
    """Every counter since the last ``reset_counters()``, the kept tensors
    and events read now (a host read each): {counter: int, "phase_ms":
    {phase span: ms}}, and "inner_ms": {inner span: ms} once an inner span
    has run."""
    later, phases, inner_marks = _later[:], _phases[:], _inner[:]
    del _later[:], _phases[:], _inner[:]
    for fn, args in later:
        _ints.update(fn(*args))
    for name, start, end in phases:
        _ms[name] += _elapsed_ms(start, end)
    for name, start, end in inner_marks:
        _inner_ms[name] += _elapsed_ms(start, end)
    out = dict(_ints, phase_ms=dict(_ms))
    if _inner_ms:
        out["inner_ms"] = dict(_inner_ms)
    return out


def reset_counters() -> None:
    """Zero every counter."""
    for kept in (_ints, _ms, _later, _phases, _inner_ms, _inner):
        kept.clear()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the body into ``log_dir/trace.json`` and its counters into
    ``log_dir/counters.json``; prints the section's wall time (``[profile]
    section took ...s``) on stderr."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset_counters()
    t0 = time.perf_counter()
    try:
        with profile(activities=activities) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
        with open(os.path.join(log_dir, "counters.json"), "w") as f:
            json.dump(counters(), f, indent=1, sort_keys=True)
    finally:
        print(f"[profile] section took {time.perf_counter() - t0:.3f}s", file=sys.stderr)


def check_finite(name: str, *tensors) -> None:
    """Host-side NaN/Inf guard: raises ``FloatingPointError`` naming the
    first tensor with non-finite values (tensors or array-likes)."""
    for i, t in enumerate(tensors):
        t = torch.as_tensor(t)
        finite = torch.isfinite(t)
        with host_wait():
            ok = bool(finite.all())
        if not ok:
            bad = t.numel() - int(finite.sum())
            raise FloatingPointError(
                f"{name}: array {i} has {bad} non-finite values "
                f"(shape {tuple(t.shape)}, dtype {t.dtype})")
