"""What a ``--trace 1`` run reads from ``torch.profiler``'s record of a
short window of whole registrations: the device's operations (kernels,
copies, fills) with their intervals, the host's operations, and the span
of each registration, from the call into the program to its result on
the host.  The per-layer readers (``metrics/``) take a ``Trace``.

The traced window is the registrations' spans together, as the timed
window is their latencies together: the benchmark's own work between
them (making the next request's clouds) is in neither.  The busy time is
the union of the intervals of the device operations launched inside
those spans (the method of the repository's ``scripts/profile_torch.py``);
an idle gap is a stretch of a span in which no device operation ran, put
down to the innermost host operation running at its midpoint.
"""

from __future__ import annotations

import bisect
import heapq
import json
import os
import re
from dataclasses import dataclass, field

REGISTRATION_SPAN = "regbench.registration"
_HERE = os.path.dirname(os.path.abspath(__file__))
_COPIES = ("Memcpy", "Memset")  # device operations that are not kernel launches


def kernel_families(path: str = os.path.join(_HERE, "kernels.json")) -> dict:
    """Family name -> compiled pattern matching its kernels' trace names."""
    with open(path) as f:
        table = json.load(f)
    return {fam: re.compile(r"(^|[\s:])(" + "|".join(map(re.escape, names)) + r")[(<]")
            for fam, names in table.items() if isinstance(names, list)}


@dataclass
class Trace:
    """One traced window.  Times in seconds from the profiler's clock."""

    spans: list  # sorted (start, end) of the registrations
    device_ops: list  # (name, start, end), the device operations launched in them
    host_ops: list  # (name, start, end), host operations
    registrations: list  # per registration: {"iters": int, ...}
    config: dict
    mix: dict
    families: dict = field(default_factory=kernel_families)

    @property
    def window_s(self) -> float:
        return sum(b - a for a, b in self.spans)

    @property
    def kernels(self) -> list:
        return [op for op in self.device_ops if not op[0].startswith(_COPIES)]

    @property
    def iterations(self) -> int:
        return sum(r["iters"] for r in self.registrations)

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, each clipped to
        its registration's span, as sorted disjoint [start, end]."""
        out = []
        for _, a, b in sorted(self.device_ops, key=lambda op: op[1]):
            lo, hi = self.spans[bisect.bisect_right(self.spans, (a, float("inf"))) - 1]
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def family_seconds(self, family: str) -> float:
        """Device seconds of the kernels of ``family`` (``kernels.json``)."""
        pat = self.families[family]
        return sum(b - a for name, a, b in self.kernels if pat.search(name))

    def device_op_seconds(self) -> list:
        """[name, seconds] of every device operation name, most first."""
        tot: dict = {}
        for name, a, b in self.device_ops:
            tot[name] = tot.get(name, 0.0) + (b - a)
        return sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])

    def idle_by_host_op(self) -> list:
        """[host operation, seconds] of the window's idle gaps, each gap put
        down to the innermost host operation running at its midpoint (the
        latest-starting one that covers it), most first."""
        busy = self.busy_intervals()
        gaps, k = [], 0
        for lo, hi in self.spans:
            t = lo
            while k < len(busy) and busy[k][0] < hi:
                if busy[k][0] > t:
                    gaps.append((t, busy[k][0]))
                t = max(t, busy[k][1])
                k += 1
            if hi > t:
                gaps.append((t, hi))
        hosts = sorted(self.host_ops, key=lambda op: op[1])
        tot: dict = {}
        active: list = []  # heap of (-start, end, name)
        h = 0
        for a, b in sorted(gaps):
            mid = 0.5 * (a + b)
            while h < len(hosts) and hosts[h][1] <= mid:
                heapq.heappush(active, (-hosts[h][1], hosts[h][2], hosts[h][0]))
                h += 1
            covering = [op for op in active if op[1] >= mid]
            active = covering
            heapq.heapify(active)
            name = active[0][2] if active else "(no host operation)"
            tot[name] = tot.get(name, 0.0) + (b - a)
        return sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])

    def breakdown(self, top: int = 10) -> dict:
        return {"device_ops": [[n[:160], s] for n, s in self.device_op_seconds()[:top]],
                "idle_gaps": [[n[:160], s] for n, s in self.idle_by_host_op()[:top]]}


def from_profiler(prof, registrations: list, config: dict, mix: dict) -> Trace:
    """A ``Trace`` of a finished ``torch.profiler.profile`` in which each
    registration was recorded as a ``REGISTRATION_SPAN`` host span."""
    from torch.autograd import DeviceType

    device, host, names = [], [], set()
    for e in prof.events():
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                device.append((e.name, a, b))
        else:
            host.append((e.name, a, b))
            if getattr(e, "is_user_annotation", False) or e.name.startswith("regbench."):
                names.add(e.name)
    spans = sorted((a, b) for name, a, b in host if name == REGISTRATION_SPAN)
    if not spans:
        raise RuntimeError(f"the profiler recorded no {REGISTRATION_SPAN} span")

    def inside(t):
        i = bisect.bisect_right(spans, (t, float("inf"))) - 1
        return i >= 0 and spans[i][0] <= t <= spans[i][1]

    # a host span's copy on the device's timeline is no device operation
    device = [op for op in device if op[0] not in names and inside(op[1])]
    return Trace(spans=spans, device_ops=device, host_ops=host,
                 registrations=registrations, config=config, mix=mix)
