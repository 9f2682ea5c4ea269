"""The kernels' launch counters, read and advanced together, by kernel name.

Each kernel wrapper adds one to its module's counter where it launches its
kernel; :data:`COUNTERS` names each counter after its kernel's source
(``csrc/<name>.cu``). A CUDA graph runs its kernels without the wrappers, so a
captured predict program takes back what the wrappers counted during its
capture (no kernel runs then) and adds that many on every replay: the
counters go on counting device launches.
"""

from __future__ import annotations

from typing import Dict

from ufm_torch.ops import flash_attention, gelu, linear_gelu, linear_swiglu, window_refinement

__all__ = ["COUNTERS", "snapshot", "since", "add", "reset"]

# kernel name -> (module, counter attribute)
COUNTERS = {
    "flash_attention_fwd": (flash_attention, "LAUNCHES"),
    "flash_attention_bwd": (flash_attention, "BWD_LAUNCHES"),
    "window_refinement_fwd": (window_refinement, "LAUNCHES"),
    "gelu_bf16_fwd": (gelu, "LAUNCHES"),
    "linear_gelu_bf16_fwd": (linear_gelu, "LAUNCHES"),
    "flash_attention_fwd_any": (flash_attention, "ANY_LAUNCHES"),
    "flash_attention_bwd_any": (flash_attention, "ANY_BWD_LAUNCHES"),
    "window_refinement_bwd": (window_refinement, "BWD_LAUNCHES"),
    "gelu_bf16_bwd": (gelu, "BWD_LAUNCHES"),
    "linear_gelu_bf16_bwd": (linear_gelu, "BWD_LAUNCHES"),
    "linear_swiglu_bf16_fwd": (linear_swiglu, "LAUNCHES"),
}


def snapshot() -> Dict[str, int]:
    """Every counter, by kernel name."""
    return {name: getattr(m, attr) for name, (m, attr) in COUNTERS.items()}


def since(before: Dict[str, int]) -> Dict[str, int]:
    """What each counter has gained since ``before`` (a :func:`snapshot`)."""
    return {name: n - before[name] for name, n in snapshot().items()}


def add(delta: Dict[str, int]) -> None:
    """Add ``delta`` (counts by kernel name, as :func:`since` gives them)."""
    for name, d in delta.items():
        m, attr = COUNTERS[name]
        setattr(m, attr, getattr(m, attr) + d)


def reset() -> None:
    """Set every counter to 0 (where a run's counts start)."""
    for m, attr in COUNTERS.values():
        setattr(m, attr, 0)
