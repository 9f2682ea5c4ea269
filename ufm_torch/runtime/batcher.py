"""Serving runtime: native continuous batching and the dispatch loop.

Counterpart of ``ufm_tpu/runtime/batcher.py``. The C++ scheduler
(``ufm_torch/csrc/host/ufm_runtime.cc``, the port's own copy, built by the host
C++ compiler into ``build/ufm_torch/`` at first use) forms batches from
asynchronous requests, releasing one when ``max_batch`` requests wait or the
oldest has waited ``max_delay_ms``, off the GIL. This module binds it with
ctypes and runs the dispatch loop: gather the payloads of a batch's ids, pad
the batch to ``max_batch`` (one static shape: one captured predict program
per lane), run the predict function, resolve each request's future.
"""

from __future__ import annotations

import ctypes
import threading
from concurrent.futures import Future
from typing import Callable, Dict, Optional

import numpy as np

from ufm_torch.ops import _build

__all__ = ["NativeBatcher", "ServingRuntime"]


def _load_lib() -> ctypes.CDLL:
    lib = _build.load_host_library("ufm_runtime")
    lib.ufm_batcher_create.restype = ctypes.c_void_p
    lib.ufm_batcher_create.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int]
    lib.ufm_batcher_shutdown.restype = None
    lib.ufm_batcher_shutdown.argtypes = [ctypes.c_void_p]
    lib.ufm_batcher_destroy.restype = None
    lib.ufm_batcher_destroy.argtypes = [ctypes.c_void_p]
    lib.ufm_batcher_submit.restype = ctypes.c_int
    lib.ufm_batcher_submit.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64]
    lib.ufm_batcher_next_batch.restype = ctypes.c_int
    lib.ufm_batcher_next_batch.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64]
    lib.ufm_batcher_stats.restype = None
    lib.ufm_batcher_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
    return lib


class NativeBatcher:
    """Thin ctypes wrapper over the C++ scheduler. Thread-safe: ``close``
    wakes every caller waiting in the scheduler and frees it only once no
    call is inside."""

    def __init__(self, max_batch: int = 8, max_delay_ms: float = 5.0, capacity: int = 256):
        self._lib = _load_lib()
        self._handle = self._lib.ufm_batcher_create(max_batch, int(max_delay_ms * 1000), capacity)
        if not self._handle:
            raise ValueError(f"invalid batcher parameters: max_batch={max_batch}, capacity={capacity}")
        self.max_batch = max_batch
        self._ids_buf = (ctypes.c_uint64 * max_batch)()
        self._state = threading.Condition()  # guards _closed and _inside
        self._closed = False
        self._inside = 0  # calls into the scheduler now running

    def _call(self, fn, *args):
        with self._state:
            if self._closed:
                raise RuntimeError("batcher is shut down")
            self._inside += 1
        try:
            return fn(self._handle, *args)
        finally:
            with self._state:
                self._inside -= 1
                self._state.notify_all()

    def submit(self, request_id: int, timeout_s: float = 10.0) -> None:
        rc = self._call(self._lib.ufm_batcher_submit, request_id, int(timeout_s * 1e6))
        if rc == -1:
            raise RuntimeError("batcher is shut down")
        if rc == -2:
            raise TimeoutError("batcher queue full")

    def next_batch(self, timeout_s: float = 1.0) -> Optional[list]:
        """Blocks up to ``timeout_s``; returns ids, [] on timeout, None once
        shut down and drained."""
        n = self._call(self._lib.ufm_batcher_next_batch, self._ids_buf, int(timeout_s * 1e6))
        if n == -1:
            return None
        return [self._ids_buf[i] for i in range(n)]

    def stats(self) -> Dict[str, float]:
        buf = (ctypes.c_uint64 * 6)()
        self._call(self._lib.ufm_batcher_stats, buf)
        submitted, dispatched, batches, sum_bs, sum_wait, pending = (buf[i] for i in range(6))
        return {
            "submitted": submitted,
            "dispatched": dispatched,
            "batches": batches,
            "mean_batch_size": sum_bs / batches if batches else 0.0,
            "mean_wait_ms": sum_wait / dispatched / 1000 if dispatched else 0.0,
            "pending": pending,
        }

    def shutdown(self) -> None:
        """Wake every waiter: later submits raise, ``next_batch`` drains what
        is pending and then returns None."""
        self._call(self._lib.ufm_batcher_shutdown)

    def close(self) -> None:
        """Shut down, wait for the calls still inside, free the scheduler."""
        with self._state:
            if self._closed:
                return
            self._closed = True
            self._lib.ufm_batcher_shutdown(self._handle)
            self._state.wait_for(lambda: self._inside == 0)
        self._lib.ufm_batcher_destroy(self._handle)


class ServingRuntime:
    """Continuous-batching inference around a batched predict function.

    ``predict_fn(src_batch, tgt_batch) -> list of per-request results``, on
    stacked numpy arrays. Requests enter through :meth:`infer`, which returns
    a Future. A short batch is padded to ``max_batch`` (repeating its last
    pair), so the device sees one static shape: one captured program.
    """

    def __init__(
        self,
        predict_fn: Callable[[np.ndarray, np.ndarray], list],
        max_batch: int = 8,
        max_delay_ms: float = 5.0,
    ):
        self._predict = predict_fn
        self._batcher = NativeBatcher(max_batch=max_batch, max_delay_ms=max_delay_ms)
        self._payloads: Dict[int, tuple] = {}
        self._futures: Dict[int, Future] = {}
        self._lock = threading.Lock()
        self._next_id = 0
        self._thread = threading.Thread(target=self._loop, name="ufm-serving", daemon=True)
        self._thread.start()

    def infer(self, source_image: np.ndarray, target_image: np.ndarray) -> Future:
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            fut: Future = Future()
            self._payloads[rid] = (source_image, target_image)
            self._futures[rid] = fut
        try:
            self._batcher.submit(rid)
        except (RuntimeError, TimeoutError):
            with self._lock:
                self._payloads.pop(rid, None)
                self._futures.pop(rid, None)
            raise
        return fut

    def _loop(self) -> None:
        while True:
            ids = self._batcher.next_batch(timeout_s=0.25)
            if ids is None:  # shut down and drained
                break
            if not ids:
                continue
            with self._lock:
                pairs = [self._payloads.pop(i) for i in ids]
                futs = [self._futures.pop(i) for i in ids]
            try:
                n = len(pairs)
                src = np.stack([p[0] for p in pairs])
                tgt = np.stack([p[1] for p in pairs])
                pad = self._batcher.max_batch - n
                if pad:  # one static batch shape: one captured program
                    src = np.concatenate([src, np.repeat(src[-1:], pad, axis=0)])
                    tgt = np.concatenate([tgt, np.repeat(tgt[-1:], pad, axis=0)])
                results = self._predict(src, tgt)
                for fut, res in zip(futs, results[:n]):
                    fut.set_result(res)
            except Exception as e:  # noqa: BLE001 — the loop serves on; each request gets the error
                for fut in futs:
                    if not fut.done():
                        fut.set_exception(e)

    def stats(self) -> Dict[str, float]:
        return self._batcher.stats()

    def close(self) -> None:
        """Serve what is pending, stop the loop, free the scheduler."""
        try:
            self._batcher.shutdown()
        except RuntimeError:  # closed already
            return
        self._thread.join(timeout=30.0)
        if self._thread.is_alive():
            raise RuntimeError("the serving loop did not stop within 30 s")
        self._batcher.close()
