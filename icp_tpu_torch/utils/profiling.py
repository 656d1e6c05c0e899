"""Profiling and the host-side finite check (port of
``icp_tpu/utils/profiling.py``).

``trace(log_dir)`` records a ``torch.profiler`` trace of its body (the
card's kernels too when one is present) and writes it as a Chrome trace
(``trace.json``, for Perfetto or ``chrome://tracing``) into ``log_dir``.
Where JAX's ``trace`` falls back to wall time when its profiler cannot
start, this one raises: a profiler that fails on the card is a fault to
see, not to hide.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the body into ``log_dir/trace.json``; prints the section's
    wall time (``[profile] section took ...s``) on stderr."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.perf_counter()
    try:
        with profile(activities=activities) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    finally:
        print(f"[profile] section took {time.perf_counter() - t0:.3f}s", file=sys.stderr)


def check_finite(name: str, *tensors) -> None:
    """Host-side NaN/Inf guard: raises ``FloatingPointError`` naming the
    first tensor with non-finite values (tensors or array-likes)."""
    for i, t in enumerate(tensors):
        t = torch.as_tensor(t)
        finite = torch.isfinite(t)
        if not bool(finite.all()):
            bad = t.numel() - int(finite.sum())
            raise FloatingPointError(
                f"{name}: array {i} has {bad} non-finite values "
                f"(shape {tuple(t.shape)}, dtype {t.dtype})")
