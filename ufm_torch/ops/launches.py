"""The kernels' launch counters, read and advanced together.

Each kernel wrapper adds one to its module's counter where it launches its
kernel (``flash_attention.LAUNCHES``, ``flash_attention.BWD_LAUNCHES``,
``flash_attention.ANY_LAUNCHES``, ``flash_attention.ANY_BWD_LAUNCHES``,
``window_refinement.LAUNCHES``, ``gelu.LAUNCHES``,
``linear_gelu.LAUNCHES``, ``window_refinement.BWD_LAUNCHES``). A CUDA
graph runs its kernels without the wrappers, so a captured predict program
takes back what the wrappers counted during its capture (no kernel runs
then) and adds that many on every replay: the counters go on counting
device launches.
"""

from __future__ import annotations

from typing import Tuple

from ufm_torch.ops import flash_attention, gelu, linear_gelu, window_refinement

__all__ = ["snapshot", "since", "add", "reset"]

_COUNTERS = (
    (flash_attention, "LAUNCHES"),
    (flash_attention, "BWD_LAUNCHES"),
    (window_refinement, "LAUNCHES"),
    (gelu, "LAUNCHES"),
    (linear_gelu, "LAUNCHES"),
    (flash_attention, "ANY_LAUNCHES"),
    (flash_attention, "ANY_BWD_LAUNCHES"),
    (window_refinement, "BWD_LAUNCHES"),
)


def snapshot() -> Tuple[int, ...]:
    """Every counter, in a fixed order."""
    return tuple(getattr(m, name) for m, name in _COUNTERS)


def since(before: Tuple[int, ...]) -> Tuple[int, ...]:
    """What each counter has gained since ``before`` (a :func:`snapshot`)."""
    return tuple(now - then for now, then in zip(snapshot(), before))


def add(delta: Tuple[int, ...]) -> None:
    """Add ``delta`` (one entry per counter, as :func:`since` gives it)."""
    for (m, name), d in zip(_COUNTERS, delta):
        setattr(m, name, getattr(m, name) + d)


def reset() -> None:
    """Set every counter to 0 (where a run's counts start)."""
    for m, name in _COUNTERS:
        setattr(m, name, 0)
