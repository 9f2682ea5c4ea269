"""Profiling helpers (counterpart of ``ufm_tpu/utils/profiling.py``).

- :func:`sync`: wait for the device work behind a tree of tensors;
- :func:`trace`: a ``torch.profiler`` trace of a block, written as a Chrome
  trace (Perfetto, ``chrome://tracing``);
- :func:`timed`: a block's time, by CUDA events where there is a GPU (device
  time from the block's start to its end), else by the host clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Iterator, Optional

import torch

__all__ = ["trace", "timed", "sync"]


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


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU and, where present, CUDA activity) and write
    ``<log_dir>/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def timed(label: str, result: Optional[dict] = None) -> Iterator[None]:
    """Time the block in seconds: by CUDA events on the current device
    (synchronised at the end) where there is a GPU, else by the host clock.
    Stores into ``result[label]`` or prints."""
    on_card = torch.cuda.is_available()
    if on_card:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if on_card:
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - t0
        if result is not None:
            result[label] = dt
        else:
            print(f"[timed] {label}: {dt * 1e3:.2f} ms")
