"""Native image-pair loader: threaded PNG / JPEG decoding off the GIL
(counterpart of ``ufm_tpu/runtime/loader.py``).

Binds the port's own copy of the loader, ``ufm_torch/csrc/host/ufm_loader.cc``,
built by the host C++ compiler into ``build/ufm_torch/`` at first use from the
repository's sources alone: its decoders (``csrc/host/image_decode.h``) give
bit for bit what the JAX package's loader gets from libpng and libjpeg. C
threads decode PNG and JPEG files (and resize them bilinearly when their size
is not the requested one) into fixed-size uint8 RGB frames, so the Python
thread stays free to feed the card: :func:`iter_decoded_pairs` is a producer
for :func:`ufm_torch.runtime.streaming.stream_predict`.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np

from ufm_torch.ops import _build

__all__ = ["NativeImageLoader", "iter_decoded_pairs"]


def _load_lib() -> ctypes.CDLL:
    lib = _build.load_host_library("ufm_loader")
    lib.ufm_loader_create.restype = ctypes.c_void_p
    lib.ufm_loader_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.ufm_loader_submit.restype = ctypes.c_int
    lib.ufm_loader_submit.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p]
    lib.ufm_loader_poll.restype = ctypes.c_int
    lib.ufm_loader_poll.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint8),
                                    ctypes.c_int64]
    lib.ufm_loader_shutdown.restype = None
    lib.ufm_loader_shutdown.argtypes = [ctypes.c_void_p]
    lib.ufm_loader_destroy.restype = None
    lib.ufm_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


class NativeImageLoader:
    """Decode images on C threads; poll fixed-size (H, W, 3) uint8 frames.
    Thread-safe: ``close`` wakes every caller waiting in ``poll`` and frees
    the loader only once no call is inside."""

    def __init__(self, out_hw: Tuple[int, int], num_threads: int = 2):
        self._lib = _load_lib()
        self.out_hw = (int(out_hw[0]), int(out_hw[1]))
        self._handle = self._lib.ufm_loader_create(num_threads, self.out_hw[0], self.out_hw[1])
        if not self._handle:
            raise ValueError(f"invalid loader parameters: out_hw={out_hw}, num_threads={num_threads}")
        self._state = threading.Condition()  # guards _closed and _inside
        self._closed = False
        self._inside = 0  # calls into the loader now running

    def _call(self, fn, *args):
        with self._state:
            if self._closed:
                raise RuntimeError("loader is shut down")
            self._inside += 1
        try:
            return fn(self._handle, *args)
        finally:
            with self._state:
                self._inside -= 1
                self._state.notify_all()

    def submit(self, request_id: int, path: str) -> None:
        if self._call(self._lib.ufm_loader_submit, request_id, path.encode()) != 0:
            raise RuntimeError("loader is shut down")

    def poll(self, timeout_s: float = 5.0) -> Optional[Tuple[int, Optional[np.ndarray]]]:
        """(id, frame) for a decoded image, (id, None) for a file that could
        not be decoded, None on timeout. Raises once the loader is closed."""
        h, w = self.out_hw
        buf = np.empty((h, w, 3), dtype=np.uint8)
        rid = ctypes.c_uint64()
        rc = self._call(self._lib.ufm_loader_poll, ctypes.byref(rid),
                        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), int(timeout_s * 1e6))
        if rc == -1:
            raise RuntimeError("loader is shut down")
        if rc == 0:
            return None
        if rc == -2:
            return int(rid.value), None
        return int(rid.value), buf

    def close(self) -> None:
        """Shut down (waking pollers), wait for the calls still inside, free
        the loader (its threads finish the decodes already submitted)."""
        with self._state:
            if self._closed:
                return
            self._closed = True
            self._lib.ufm_loader_shutdown(self._handle)
            self._state.wait_for(lambda: self._inside == 0)
        self._lib.ufm_loader_destroy(self._handle)

    def __enter__(self) -> "NativeImageLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def iter_decoded_pairs(
    pair_paths: Iterable[Tuple[str, str]],
    out_hw: Tuple[int, int],
    num_threads: int = 2,
    window: int = 8,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Decode (source, target) path pairs with a lookahead of ``window``
    pairs; yields frame pairs in submission order (a producer for
    :func:`ufm_torch.runtime.streaming.stream_predict`)."""
    paths = list(pair_paths)
    with NativeImageLoader(out_hw, num_threads) as loader:
        frames: Dict[int, np.ndarray] = {}
        next_submit = next_yield = 0

        def submit_upto(limit: int) -> None:
            nonlocal next_submit
            while next_submit < min(limit, len(paths)):
                src, tgt = paths[next_submit]
                loader.submit(2 * next_submit, src)
                loader.submit(2 * next_submit + 1, tgt)
                next_submit += 1

        submit_upto(window)
        while next_yield < len(paths):
            while 2 * next_yield not in frames or 2 * next_yield + 1 not in frames:
                polled = loader.poll(timeout_s=10.0)
                if polled is None:
                    raise TimeoutError("image decode timed out")
                rid, frame = polled
                if frame is None:
                    raise IOError(f"failed to decode {paths[rid // 2][rid % 2]}")
                frames[rid] = frame
            yield frames.pop(2 * next_yield), frames.pop(2 * next_yield + 1)
            next_yield += 1
            submit_upto(next_yield + window)
