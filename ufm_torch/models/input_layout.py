"""The memory order of a predict input, buffers laid out in it, and a count
of how each input was staged.

``predict_correspondences_batched`` stages every input in its own memory
order: a captured program's pinned staging buffer and static device buffer
are laid out as the input is (its program key carries the order), so each of
the two copies is one flat memcpy, and the one layout change the model needs
(channel-last, for its normalize) runs on the card inside the graph. An input
whose elements do not fill one dense block (a crop view, a broadcast) is
gathered into channel-last buffers by the staging copy itself.

:data:`COUNTS` counts the inputs by how they were staged, in the manner of
the kernels' launch counters (:mod:`ufm_torch.ops.launches`):

- ``own_order``: a dense input, staged in its own order (one memcpy);
- ``gathered``: an input that is not dense, gathered into channel-last order
  by the staging copy;
- ``host_copy``: a numpy array torch cannot view (a negative stride, or one
  that is no multiple of the item size), copied into C order on the host
  first.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

__all__ = ["CHANNEL_LAST", "COUNTS", "memory_order", "empty_in_order", "count", "snapshot", "since"]

# (B, C, H, W) dims from the outermost in memory to the innermost: BHWC memory
CHANNEL_LAST = (0, 2, 3, 1)

COUNTS: Dict[str, int] = {"own_order": 0, "gathered": 0, "host_copy": 0}
_LOCK = threading.Lock()  # the server's lanes count from several threads


def memory_order(t: torch.Tensor) -> Optional[Tuple[int, ...]]:
    """The dims of ``t`` from the outermost in memory to the innermost, where
    its elements fill one dense block; ``None`` where they do not. Dims of
    size 1 (whose strides say nothing) come first, in their own order."""
    ones = [d for d in range(t.dim()) if t.shape[d] == 1]
    rest = sorted((d for d in range(t.dim()) if t.shape[d] != 1), key=t.stride, reverse=True)
    step = 1
    for d in reversed(rest):
        if t.stride(d) != step:
            return None
        step *= t.shape[d]
    return (*ones, *rest)


def empty_in_order(shape: Sequence[int], order: Sequence[int], dtype: torch.dtype, **kw) -> torch.Tensor:
    """An uninitialised tensor of ``shape`` laid out in memory in ``order``
    (as :func:`memory_order` gives it); ``kw`` as ``torch.empty``'s."""
    mem = torch.empty([shape[d] for d in order], dtype=dtype, **kw)
    return mem.permute(*(list(order).index(d) for d in range(len(order))))


def count(kinds: Iterable[str]) -> None:
    """Count one staged input of each of ``kinds``."""
    with _LOCK:
        for kind in kinds:
            COUNTS[kind] += 1


def snapshot() -> Dict[str, int]:
    """Every count, by kind."""
    with _LOCK:
        return dict(COUNTS)


def since(before: Dict[str, int]) -> Dict[str, int]:
    """What each count has gained since ``before`` (a :func:`snapshot`)."""
    return {kind: n - before[kind] for kind, n in snapshot().items()}
