"""What the program's span recorder (``ufm_torch.utils.profiling``) holds
after a traced run, for the per-layer metrics that read it.

Spans are recorded only under a profile, and the traced stretch is the one
profile a run takes: every span read here is the stretch's. Each function
returns None where nothing was recorded (a run without a trace, or a program
without the recorder).

The spans' host times are Unix ns (``time.time_ns()``); the stretch's trace
is in µs from the profiler's start. :func:`named_idle_share` puts the spans
on the trace's clock: by their own ``record_function`` events where the
profile kept them as host events, else by the one ``cudaGraphLaunch`` that
each ``predict.launch`` span holds (the offset lies in every call's range).
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional, Tuple


def recorded(run) -> list:
    """The program's spans, or [] where there are none to read."""
    if getattr(run, "stretch", None) is None:
        return []
    try:
        from ufm_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "spans", None)
    return list(read()) if callable(read) else []


def host_ms(run, name: str) -> Optional[float]:
    """The median host ms of the spans named ``name``."""
    times = [sp.host_ms for sp in recorded(run) if sp.name == name and sp.host_ms is not None]
    return statistics.median(times) if times else None


def device_ms(run, names: Iterable[str]) -> Optional[float]:
    """The median, over the calls or steps that timed every one of
    ``names`` on the device, of their summed device ms."""
    names = set(names)
    by_call: Dict[int, Dict[str, float]] = {}
    for sp in recorded(run):
        if sp.name in names and sp.device_ms is not None:
            got = by_call.setdefault(sp.call, {})
            got[sp.name] = got.get(sp.name, 0.0) + sp.device_ms
    sums = [sum(got.values()) for got in by_call.values() if set(got) == names]
    return statistics.median(sums) if sums else None


def _union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _on_trace_clock(stretch, spans: list, prefix: str) -> Optional[List[Tuple[float, float]]]:
    """The intervals (trace µs) of the spans whose name starts with ``prefix``."""
    kept = [(a, b) for a, b, name in stretch.host_events if name.startswith(prefix)]
    if kept:  # the profile kept the spans' record_function events
        return kept
    host = [sp for sp in spans if sp.start_ns is not None and sp.end_ns is not None]
    launches = sorted((sp for sp in host if sp.name == "predict.launch"), key=lambda sp: sp.start_ns)
    graph_launches = sorted((a, b) for a, b, name in stretch.host_events if name == "cudaGraphLaunch")
    if not launches or len(launches) != len(graph_launches):
        return None
    base = launches[0].start_ns
    # trace µs = (ns - base) / 1e3 + offset, with each launch span around its cudaGraphLaunch
    lo = max(b - (sp.end_ns - base) / 1e3 for sp, (_, b) in zip(launches, graph_launches))
    hi = min(a - (sp.start_ns - base) / 1e3 for sp, (a, _) in zip(launches, graph_launches))
    if lo > hi:
        return None
    offset = 0.5 * (lo + hi)
    return [((sp.start_ns - base) / 1e3 + offset, (sp.end_ns - base) / 1e3 + offset)
            for sp in host if sp.name.startswith(prefix)]


def named_idle_share(run, prefix: str) -> Optional[float]:
    """The share (%) of the stretch's idle time (the gaps between its device
    intervals) that lies inside a span whose name starts with ``prefix``."""
    spans = recorded(run)
    if not spans:
        return None
    stretch = run.stretch
    named = _on_trace_clock(stretch, spans, prefix)
    if named is None:
        return None
    busy = _union((a, b) for a, b, _ in stretch.device_events)
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    total = sum(b - a for a, b in gaps)
    if total <= 0:
        return None
    inside, j = 0.0, 0
    named = _union(named)
    for a, b in gaps:  # both sorted and disjoint: one sweep
        while j < len(named) and named[j][1] <= a:
            j += 1
        k = j
        while k < len(named) and named[k][0] < b:
            inside += min(b, named[k][1]) - max(a, named[k][0])
            k += 1
    return 100.0 * inside / total
