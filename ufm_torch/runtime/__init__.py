"""Serving and deployment: the continuous batcher, the HTTP daemon, the
streaming loop, ``torch.export`` artifacts and the native image loader
(counterpart of ``ufm_tpu/runtime``).

The export and loader names are imported on first use, so importing this
package builds nothing and imports no model code."""

import importlib

from ufm_torch.runtime.batcher import NativeBatcher, ServingRuntime
from ufm_torch.runtime.server import UFMServer, serve
from ufm_torch.runtime.streaming import stream_predict, stream_predict_staged

_LAZY = {
    "export_model": "export",
    "load_exported": "export",
    "load_artifact_model": "export",
    "ExportedUFM": "export",
    "ArtifactUFM": "export",
    "ARTIFACT_SUFFIX": "export",
    "NativeImageLoader": "loader",
    "iter_decoded_pairs": "loader",
}

__all__ = [
    "NativeBatcher",
    "ServingRuntime",
    "UFMServer",
    "serve",
    "stream_predict",
    "stream_predict_staged",
    *_LAZY,
]


def __getattr__(name: str):
    if name in _LAZY:
        return getattr(importlib.import_module(f"ufm_torch.runtime.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
