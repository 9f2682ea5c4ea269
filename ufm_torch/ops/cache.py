"""A cache for device constants that a trace never fills.

The resize matrices, position embeddings and unmap grids are built on the
host and copied to their device once, then cached per device (unbounded: a
captured CUDA graph keeps the address of what it read, so a forward never
makes a host-to-device copy). Under ``torch.export`` or ``torch.compile`` the
same call would return a tensor of the trace (a fake tensor), which must
never enter the cache: a later trace, or an eager call, would be handed a
tensor of a trace that has ended. While tracing, the constant is built anew
outside the trace, a real tensor on its device, and the trace records it as
a constant of its program: the program makes no host-to-device copy either.
"""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import _disable_current_modes

__all__ = ["device_constant"]


def device_constant(fn):
    """``functools.lru_cache(maxsize=None)`` over ``fn``, bypassed while
    ``torch.compiler.is_compiling()`` (``torch.export`` and ``torch.compile``
    tracing)."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if torch.compiler.is_compiling():
            with _disable_current_modes():  # a real tensor on its device, made outside the trace
                return fn(*args, **kwargs)
        return cached(*args, **kwargs)

    return wrapper
