"""Serving: the continuous batcher, the HTTP daemon and the streaming loop
(counterpart of ``ufm_tpu/runtime``; export is not ported yet)."""

from ufm_torch.runtime.batcher import NativeBatcher, ServingRuntime
from ufm_torch.runtime.server import UFMServer, serve
from ufm_torch.runtime.streaming import stream_predict, stream_predict_staged

__all__ = ["NativeBatcher", "ServingRuntime", "UFMServer", "serve", "stream_predict", "stream_predict_staged"]
