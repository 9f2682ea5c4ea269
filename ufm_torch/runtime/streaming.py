"""Double-buffered streaming inference (counterpart of
``ufm_tpu/runtime/streaming.py``).

For continuous streams of pairs (video flow, dataset sweeps), throughput
needs three stages to overlap: host preprocessing of batch N+1, its
host-to-device copy, and the device's work on batch N. A producer thread
preprocesses and stacks batches into a bounded queue; the loop copies each
batch from pinned memory on a copy stream, makes the compute stream wait for
that copy only (an event), enqueues the forward, and only then hands out the
previous batch's outputs (a one-deep pipeline): the device never waits for
the host to consume a result.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["stream_predict", "stream_predict_staged"]


def _take(tree: Any, n: int) -> Any:
    """The first ``n`` rows of every tensor in ``tree`` (tensors, dicts,
    lists, tuples, output dataclasses; anything else as it is)."""
    if isinstance(tree, torch.Tensor):
        return tree[:n]
    if isinstance(tree, dict):
        return {k: _take(v, n) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_take(v, n) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _take(getattr(tree, f.name), n) for f in dataclasses.fields(tree)})
    return tree


def _batches(pair_iterator, batch_size: int, preprocess, prefetch: int):
    """A started producer thread filling a bounded queue with (src, tgt,
    valid) stacked numpy batches, the last one padded by repeating its last
    pair; ``None`` ends the queue. Returns (queue, thread, errors)."""
    work: "queue.Queue" = queue.Queue(maxsize=prefetch)
    errors = []

    def producer():
        try:
            batch_src, batch_tgt = [], []
            for src, tgt in pair_iterator:
                if preprocess is not None:
                    src, tgt = preprocess(src), preprocess(tgt)
                batch_src.append(src)
                batch_tgt.append(tgt)
                if len(batch_src) == batch_size:
                    work.put((np.stack(batch_src), np.stack(batch_tgt), batch_size))
                    batch_src, batch_tgt = [], []
            if batch_src:
                n = len(batch_src)
                batch_src += [batch_src[-1]] * (batch_size - n)
                batch_tgt += [batch_tgt[-1]] * (batch_size - n)
                work.put((np.stack(batch_src), np.stack(batch_tgt), n))
        except Exception as e:  # noqa: BLE001 — handed to the consumer, which raises it
            errors.append(e)
        finally:
            work.put(None)

    thread = threading.Thread(target=producer, name="ufm-stream-producer", daemon=True)
    thread.start()
    return work, thread, errors


def _stream(dispatch: Callable, pair_iterator, batch_size: int, preprocess, prefetch: int, device) -> Iterator[Any]:
    device = torch.device(device)
    work, thread, errors = _batches(pair_iterator, batch_size, preprocess, prefetch)
    on_card = device.type == "cuda"
    if on_card:
        compute = torch.cuda.current_stream(device)
        copy = torch.cuda.Stream(device)
    in_flight = None  # (outputs, valid rows)
    try:
        while True:
            item = work.get()
            if item is None:
                break
            src, tgt, n = item
            dev_in = []
            for a in (src, tgt):
                host = torch.from_numpy(a)
                if on_card:
                    # pinned (PyTorch's host cache keeps the buffer until the
                    # copy is done), copied on the copy stream; the compute
                    # stream waits for that copy only
                    host = host.pin_memory()
                    with torch.cuda.stream(copy):
                        t = host.to(device, non_blocking=True)
                    t.record_stream(compute)
                    compute.wait_stream(copy)
                else:
                    t = host.to(device)
                dev_in.append(t)
            # enqueue the next batch before handing out the previous result:
            # the device keeps working while the caller consumes it
            out = dispatch(*dev_in)
            if in_flight is not None:
                yield _take(*in_flight)
            in_flight = (out, n)
        if errors:
            raise errors[0]
        if in_flight is not None:
            yield _take(*in_flight)
    finally:
        thread.join(timeout=1.0)


def stream_predict(
    forward: Callable,
    pair_iterator: Iterable[Tuple[np.ndarray, np.ndarray]],
    batch_size: int,
    preprocess: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    prefetch: int = 2,
    device: Union[None, str, torch.device] = None,
) -> Iterator[Any]:
    """Stream (source, target) numpy pairs through ``forward``.

    ``forward(src_batch, tgt_batch) -> outputs`` takes tensors on ``device``
    (default: the GPU) with a static batch of ``batch_size`` (a captured
    predict program per shape, e.g. ``model.predict_correspondences_batched``);
    the last batch is padded and its outputs cut back. Yields each batch's
    outputs (tensors, dicts, tuples or output dataclasses) in order, while the
    next batch is already queued on the device.
    """
    return _stream(forward, pair_iterator, batch_size, preprocess, prefetch, device or "cuda")


def stream_predict_staged(
    stage1: Callable,
    stage2: Callable,
    pair_iterator: Iterable[Tuple[np.ndarray, np.ndarray]],
    batch_size: int,
    preprocess: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    prefetch: int = 2,
    device: Union[None, str, torch.device] = None,
) -> Iterator[Any]:
    """Stream pairs through a two-dispatch pipeline: ``stage1(src_batch,
    tgt_batch)`` returns intermediates on the device (a tuple, or one value)
    and ``stage2(*intermediates)`` the outputs. Both dispatches of batch N+1
    are enqueued before batch N's outputs are handed out; the intermediates
    never leave the device. Otherwise as :func:`stream_predict`. (UFM-Refine's
    predict is one captured program on the card; the JAX package's two
    refine programs are its network's ``backbone``, returning ``flow``,
    ``cls_in_0`` and ``cls_in_1``, and ``refine_tail(img1, img2, flow,
    cls_in_0, cls_in_1)``, which make the two stages here on normalized
    model-resolution images.)"""

    def dispatch(src, tgt):
        mid = stage1(src, tgt)
        return stage2(*mid) if isinstance(mid, tuple) else stage2(mid)

    return _stream(dispatch, pair_iterator, batch_size, preprocess, prefetch, device or "cuda")
