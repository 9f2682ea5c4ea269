"""Profiling helpers (counterpart of ``ufm_tpu/utils/profiling.py``) and the
port's span recorder.

- :func:`sync`: wait for the device work behind a tree of tensors;
- :func:`span`: name a stretch of the program's work. A span records only
  while ``torch.profiler`` runs on the calling thread; otherwise it is one
  shared no-op context (no allocation, no clock read, no CUDA event). A
  recorded span keeps its name, its parent span, the call or step it belongs
  to and its host times on the profiler's clock (Unix ns, ``time.time_ns()``);
  a span given a CUDA ``device`` also times its device work by a pair of
  CUDA events, read when the spans are read;
- :func:`capturing`: spans entered while a CUDA graph is captured on this
  thread record timing events into the graph (``external`` events: a node
  of the graph, in every replay); a replay's stage times are read while a
  profile runs, before that graph is replayed again, and never wait for the
  device;
- :func:`spans`: what was recorded, device times read where complete;
- :func:`trace`: a ``torch.profiler`` trace of a block, written as a Chrome
  trace (Perfetto, ``chrome://tracing``) with the block's spans.

The JAX package marks the same stage boundaries with ``jax.named_scope``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

__all__ = ["trace", "sync", "span", "spans", "clear", "capturing", "Span", "GraphStages", "Recorder", "RECORDER"]

_profiler_enabled = torch._C._autograd._profiler_enabled


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "__dict__"):  # output dataclasses
        yield from _tensors(vars(tree))


def sync(tree: Any) -> None:
    """``torch.cuda.synchronize`` on each CUDA device that holds a tensor of
    ``tree`` (tensors, dicts, lists, tuples, output dataclasses); CPU tensors
    are complete already."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class Span:
    """One recorded span. ``parent`` is the enclosing span's ``id`` (None at
    the top); ``call`` numbers the predict call or train step it belongs to.
    ``start_ns`` / ``end_ns`` are on the profiler's clock; a stage read from
    a replayed graph has none (its parent is the replay's ``predict.launch``).
    ``device_ms`` is the device time between its CUDA events, once read."""

    name: str
    id: int
    parent: Optional[int]
    call: int
    thread: int
    start_ns: Optional[int] = None
    end_ns: Optional[int] = None
    device_ms: Optional[float] = None

    @property
    def host_ms(self) -> Optional[float]:
        return None if self.start_ns is None or self.end_ns is None else (self.end_ns - self.start_ns) / 1e6


class GraphStages:
    """The timing events captured into one CUDA graph: (span name, start,
    end) in capture order. Its owner counts the graph's replays in
    ``replays``, so that a reading left from a traced replay is never taken
    from a later one."""

    def __init__(self):
        self.stages: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = []
        self.replays = 0


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def _timing_event(external: bool = False):
    return torch.cuda.Event(enable_timing=True, external=external)


class _Active:
    """A span that records: on the host (under a profile), into a captured
    graph (during a capture on this thread), or both."""

    __slots__ = ("rec", "name", "call", "device", "graph", "sink", "host", "span", "rf", "events", "stage")

    def __init__(self, rec: "Recorder", name: str, call: bool, device, graph, sink, host: bool):
        self.rec, self.name, self.call, self.device, self.graph = rec, name, call, device, graph
        self.sink, self.host = sink, host
        self.span = self.rf = self.events = self.stage = None

    def __enter__(self):
        if self.sink is not None:
            self.stage = (_timing_event(external=True), _timing_event(external=True))
            self.stage[0].record()
        if self.host:
            rec = self.rec
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
            if self.graph is not None:
                rec._read_replay(self.graph)
            stack = rec._stack()
            parent = stack[-1] if stack else None
            call = next(rec._calls) if self.call or parent is None else parent.call
            self.span = Span(self.name, next(rec._ids), parent.id if parent else None, call, threading.get_ident())
            rec._spans.append(self.span)
            stack.append(self.span)
            if self.device is not None and self.device.type == "cuda":
                self.events = (_timing_event(), _timing_event())
                self.events[0].record(torch.cuda.current_stream(self.device))
            self.span.start_ns = time.time_ns()
        return self.span

    def __exit__(self, *exc):
        if self.host:
            rec, sp = self.rec, self.span
            sp.end_ns = time.time_ns()
            with rec._lock:
                if self.events is not None:
                    self.events[1].record(torch.cuda.current_stream(self.device))
                    rec._timed.append((sp, *self.events))
                if self.graph is not None:
                    rec._replayed[id(self.graph)] = (self.graph, self.graph.replays, sp)
            rec._stack().pop()
            self.rf.__exit__(*exc)
        if self.stage is not None:
            self.stage[1].record()
            self.sink.stages.append((self.name, *self.stage))
        return False


class Recorder:
    """The spans of one process (:data:`RECORDER`; the module's functions
    are its methods). Spans stay in memory until read or cleared."""

    def __init__(self):
        self._spans: List[Span] = []
        self._local = threading.local()
        self._ids = itertools.count()
        self._calls = itertools.count()
        self._lock = threading.Lock()
        self._sinks: Dict[int, GraphStages] = {}  # thread id -> the graph it captures
        self._timed: List[Tuple[Span, torch.cuda.Event, torch.cuda.Event]] = []  # device times not read yet
        self._replayed: Dict[int, Tuple[GraphStages, int, Span]] = {}  # a traced replay not read yet, by graph

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, *, call: bool = False, device: Optional[torch.device] = None,
             graph: Optional[GraphStages] = None):
        """A context manager naming a stretch of work. ``call``: the span
        opens a new call (a predict call, a train step); otherwise it belongs
        to its parent's call, or opens one at the top. ``device``: time its
        device work on that device's current stream too. ``graph``: the span
        replays that graph (its previous traced replay is read first)."""
        if self._sinks:
            sink = self._sinks.get(threading.get_ident())
            if sink is not None:
                return _Active(self, name, call, device, graph, sink, _profiler_enabled())
        if not _profiler_enabled():
            return _NOOP
        return _Active(self, name, call, device, graph, None, True)

    @contextlib.contextmanager
    def capturing(self) -> Iterator[GraphStages]:
        """Around a CUDA graph's capture on this thread: the spans entered
        inside record a pair of external timing events each into the graph,
        listed in the :class:`GraphStages` yielded."""
        stages, me = GraphStages(), threading.get_ident()
        self._sinks[me] = stages
        try:
            yield stages
        finally:
            del self._sinks[me]

    def _read_replay(self, graph: GraphStages) -> None:
        """Read the stage times of ``graph``'s last traced replay if it is
        still the graph's last replay and complete; drop it otherwise."""
        with self._lock:
            pending = self._replayed.pop(id(graph), None)
            if pending is not None:
                self._take(pending)  # not complete by now: skipped, never waited for

    def _take(self, pending) -> bool:
        """Append the stages of a traced replay as spans; False where the
        replay is not complete (kept) or was replayed over (dropped)."""
        graph, replays, launch = pending
        if graph.replays != replays or not graph.stages:
            return True
        if not graph.stages[-1][2].query():
            return False
        for name, start, end in graph.stages:
            self._spans.append(Span(name, next(self._ids), launch.id, launch.call, launch.thread,
                                    device_ms=start.elapsed_time(end)))
        return True

    def spans(self) -> List[Span]:
        """Every span recorded so far, in the order they opened (a replay's
        stages when read), with the device times that are complete read."""
        with self._lock:
            for key, pending in list(self._replayed.items()):
                if self._take(pending):
                    del self._replayed[key]
            waiting = []
            for sp, start, end in self._timed:
                if end.query():
                    sp.device_ms = start.elapsed_time(end)
                else:
                    waiting.append((sp, start, end))
            self._timed = waiting
            return list(self._spans)

    def clear(self) -> None:
        """Forget every span and every reading not taken yet."""
        with self._lock:
            self._spans, self._timed = [], []
            self._replayed.clear()

    def mark(self) -> int:
        """An id below every span recorded from now on."""
        return next(self._ids)


RECORDER = Recorder()
span = RECORDER.span
spans = RECORDER.spans
clear = RECORDER.clear
capturing = RECORDER.capturing


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU and, where present, CUDA activity) and write
    ``<log_dir>/trace.json``: the profiler's events and, on a track of their
    own, the block's spans (device times and a replay's stage times in their
    ``args``). The way to record the port's spans and kernels together."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    first = RECORDER.mark()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, [sp for sp in RECORDER.spans() if sp.id > first])


def _add_spans(path: str, recorded: List[Span]) -> None:
    """Append ``recorded`` to the Chrome trace at ``path`` ("X" events on the
    profiler's clock; stages read from a replay go into their launch's args)."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    stages: Dict[int, Dict[str, float]] = {}
    for sp in recorded:
        if sp.start_ns is None and sp.device_ms is not None:
            stages.setdefault(sp.parent, {})[sp.name] = sp.device_ms
    events = doc.setdefault("traceEvents", [])
    for sp in recorded:
        if sp.start_ns is None or sp.end_ns is None:
            continue
        args = {"call": sp.call, "id": sp.id, "parent": sp.parent}
        if sp.device_ms is not None:
            args["device_ms"] = sp.device_ms
        if sp.id in stages:
            args["stages_ms"] = stages[sp.id]
        events.append({"ph": "X", "cat": "ufm_torch.span", "name": sp.name, "pid": "ufm_torch spans",
                       "tid": sp.thread, "ts": (sp.start_ns - base) / 1e3, "dur": (sp.end_ns - sp.start_ns) / 1e3,
                       "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)
