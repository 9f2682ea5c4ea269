"""The traced stretch: ``torch.profiler`` over a few steady calls or steps,
reduced to device busy time, kernel time by name, and idle gaps named by
what the host was doing.

Busy time is the union of the intervals of every operation on the device
(kernels, copies and memsets; not the ``record_function`` spans the
profiler also draws there), so work that overlaps is counted once. An idle
gap lies between two busy intervals; it is named by the innermost host-side
event that spans its middle (a CUDA runtime call), under the outermost
one there.
"""

from __future__ import annotations

import heapq
import re
import time
from typing import Callable, Dict, List, Tuple

import torch

__all__ = ["Trace", "profile_stretch"]


class Trace:
    """What one traced stretch recorded: device intervals (start, end, name)
    and host events (start, end, name), in microseconds, and the
    stretch's host-clock length in seconds."""

    def __init__(self, device_events: List[Tuple[float, float, str]], host_events: List[Tuple[float, float, str]],
                 window_s: float, units: int):
        self.device_events = sorted(device_events)
        self.host_events = host_events
        self.window_s = window_s
        self.units = units  # calls or steps in the stretch

    def busy_s(self) -> float:
        busy, end = 0.0, float("-inf")
        for start, stop, _ in self.device_events:
            if stop > end:
                busy += stop - max(start, end)
                end = stop
        return busy / 1e6

    def kernel_s(self, pattern: str) -> Tuple[float, int]:
        """Summed device time (s) and count of the kernels whose name holds a
        match of ``pattern`` (not preceded by a letter or an underscore)."""
        rx = re.compile(rf"(?<![A-Za-z_]){pattern}")
        hits = [(b - a) for a, b, n in self.device_events if rx.search(n)]
        return sum(hits) / 1e6, len(hits)

    def top_device_ops(self, n: int = 10) -> List[List]:
        totals: Dict[str, float] = {}
        for a, b, name in self.device_events:
            key = _short(name)
            totals[key] = totals.get(key, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The idle time between busy intervals, summed by what the host was
        doing at each gap's middle; the ``n`` largest."""
        gaps, end = [], None
        for start, stop, _ in self.device_events:
            if end is not None and start > end:
                gaps.append((end, start))
            end = stop if end is None else max(end, stop)
        totals: Dict[str, float] = {}
        host = sorted(self.host_events)
        active: List[Tuple[float, float, str]] = []  # a heap of (end, start, name) of events begun so far
        j = 0
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = 0.5 * (a + b)
            while j < len(host) and host[j][0] <= mid:
                heapq.heappush(active, (host[j][1], host[j][0], host[j][2]))
                j += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            if active:
                spans = sorted((e - s, name) for e, s, name in active)
                label = spans[0][1] if len(spans) == 1 else f"{spans[-1][1]} > {spans[0][1]}"
            else:
                label = "host between ops"
            totals[label] = totals.get(label, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def _short(name: str, limit: int = 120) -> str:
    name = re.sub(r"^void ", "", name)
    return name if len(name) <= limit else name[:limit - 3] + "..."


def profile_stretch(fn: Callable[[int], None], units: int, device) -> Trace:
    """Run ``fn(i)`` for i < ``units`` under the profiler, then synchronize;
    return the stretch's :class:`Trace`. Only CUDA activity is recorded (the
    device's operations and the CUDA runtime calls that launched them):
    recording every host op slows a host-bound step by half again and would
    read as idle time on the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(units):
            fn(i)
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    dev, host = [], []
    for evt in prof.events():
        rng = (evt.time_range.start, evt.time_range.end)
        if evt.device_type == DeviceType.CUDA:
            dev.append((*rng, evt.name, getattr(evt, "is_user_annotation", False)))
        elif evt.device_type == DeviceType.CPU:
            host.append((*rng, evt.name))
    # a ``record_function`` span (the optimizer's step, say) is also drawn on
    # the device's timeline; it is no operation there
    dev = [(a, b, name) for a, b, name, annotation in dev if not annotation]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity in the traced stretch")
    return Trace(dev, host, window_s, units)
