"""HTTP serving daemon (counterpart of ``ufm_tpu/runtime/server.py``).

A stdlib-only HTTP front end over :class:`~ufm_torch.runtime.batcher.ServingRuntime`
(the C++ continuous batcher) serving one live model.

Endpoints
---------
``GET /healthz``
    JSON: model class, native resolution, backend (``"cuda"`` or ``"cpu"``),
    device name, uptime, lanes.
``GET /stats``
    JSON: the batcher's counters (submitted, dispatched, batches, mean batch
    size, mean wait) per shape lane.
``POST /v1/predict``
    Request body: an ``.npz`` with ``source`` / ``target`` uint8 HWC arrays,
    or JSON ``{"source_png_b64": ..., "target_png_b64": ...}`` (PNG by the
    port's codec; another image format needs ``cv2``, without which the
    answer is 400). Response: an ``.npz`` with
    ``flow`` (2, H, W) float32 at the input resolution and, where the model
    makes them, ``covisibility`` (H, W) and ``keypoint_confidence`` (H, W).

Requests are grouped into lanes by their (source, target) shape pair; each
lane owns one ``ServingRuntime`` that pads its batches to ``max_batch``, so
each lane is one static shape: one captured predict program of the model,
replayed for every batch.
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ufm_torch.runtime.batcher import ServingRuntime

__all__ = ["UFMServer", "serve"]


def _decode_request(body: bytes, content_type: str) -> Tuple[np.ndarray, np.ndarray]:
    if content_type.startswith("application/json"):
        import base64

        from ufm_torch.utils.image_io import decode_rgb

        try:
            payload = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"not a JSON body: {e}") from None
        out = []
        for key in ("source_png_b64", "target_png_b64"):
            if key not in payload:
                raise ValueError(f"JSON request missing {key!r}")
            try:
                out.append(decode_rgb(base64.b64decode(payload[key]), name=key))
            except ImportError as e:  # a non-PNG image where cv2 is missing
                raise ValueError(str(e)) from None
        return out[0], out[1]

    try:
        z = np.load(io.BytesIO(body), allow_pickle=False)
    except (OSError, ValueError) as e:
        raise ValueError(f"not an npz body: {e}") from None
    with z:
        if not hasattr(z, "files") or "source" not in z.files or "target" not in z.files:
            raise ValueError("npz request must contain 'source' and 'target' arrays")
        return np.asarray(z["source"]), np.asarray(z["target"])


def _encode_result(result: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **result)
    return buf.getvalue()


class UFMServer:
    """Serving daemon: per-shape continuous-batching lanes over one model."""

    def __init__(
        self,
        model,
        host: str = "127.0.0.1",
        port: int = 8000,
        max_batch: int = 1,
        max_delay_ms: float = 3.0,
    ):
        self.model = model
        self.host = host
        self.port = port
        self.max_batch = int(max_batch)
        self.max_delay_ms = float(max_delay_ms)
        self._lanes: Dict[Tuple[int, ...], ServingRuntime] = {}
        self._lane_lock = threading.Lock()
        self._started = time.time()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- model plumbing ----------------------------------------------------
    def _predict_batch(self, src: np.ndarray, tgt: np.ndarray) -> list:
        res = self.model.predict_correspondences_batched(src, tgt)
        # one copy to the host per output and batch; a model without the
        # uncertainty head (UniFlowMatch) answers with the flow alone
        fields = {"flow": res.flow.flow_output}
        if res.covisibility is not None:
            fields["covisibility"] = res.covisibility.mask
        if res.keypoint_confidence is not None:
            fields["keypoint_confidence"] = res.keypoint_confidence
        host = {k: v.float().cpu().numpy() for k, v in fields.items()}
        return [{k: v[i] for k, v in host.items()} for i in range(src.shape[0])]

    def _lane(self, shape: Tuple[int, ...]) -> ServingRuntime:
        with self._lane_lock:
            lane = self._lanes.get(shape)
            if lane is None:
                lane = ServingRuntime(self._predict_batch, max_batch=self.max_batch, max_delay_ms=self.max_delay_ms)
                self._lanes[shape] = lane
            return lane

    def predict(self, source: np.ndarray, target: np.ndarray) -> Dict[str, np.ndarray]:
        for name, img in (("source", source), ("target", target)):
            if img.ndim != 3 or img.shape[-1] != 3:
                raise ValueError(f"expected HWC RGB {name} image, got shape {img.shape}")
            if img.dtype != np.uint8:
                raise ValueError(f"expected a uint8 {name} image, got {img.dtype}")
        # each view is resized to the model grid on its own, so source and
        # target may differ in size: lanes are keyed by the shape pair
        key = tuple(source.shape) + tuple(target.shape)
        return self._lane(key).infer(source, target).result(timeout=300.0)

    def health(self) -> Dict[str, object]:
        dev = self.model.device
        w, h = self.model.inference_resolution[0]
        return {
            "status": "ok",
            "model_class": type(self.model).__name__,
            "resolution_wh": [w, h],
            "backend": dev.type,
            "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "uptime_s": round(time.time() - self._started, 1),
            "lanes": len(self._lanes),
        }

    def stats(self) -> Dict[str, Dict[str, float]]:
        with self._lane_lock:
            return {"x".join(map(str, shape)): lane.stats() for shape, lane in self._lanes.items()}

    # -- HTTP --------------------------------------------------------------
    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *a):  # quiet by default
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, obj) -> None:
                self._send(code, json.dumps(obj).encode("utf-8"), "application/json")

            def do_GET(self):
                if self.path == "/healthz":
                    self._send_json(200, server.health())
                elif self.path == "/stats":
                    self._send_json(200, server.stats())
                else:
                    self._send_json(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(length)  # read it in any case: the connection is kept alive
                if self.path != "/v1/predict":
                    self._send_json(404, {"error": f"unknown path {self.path}"})
                    return
                try:
                    src, tgt = _decode_request(body, self.headers.get("Content-Type", ""))
                    result = server.predict(src, tgt)
                except ValueError as e:
                    self._send_json(400, {"error": str(e)})
                    return
                except Exception as e:  # noqa: BLE001 — wire errors back, keep serving
                    self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                self._send(200, _encode_result(result), "application/x-npz")

        return Handler

    def start(self) -> None:
        self._httpd = ThreadingHTTPServer((self.host, self.port), self._make_handler())
        self.port = self._httpd.server_address[1]  # resolve port 0
        self._thread = threading.Thread(target=self._httpd.serve_forever, name="ufm-http", daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        """Serve until the HTTP loop stops (started here if not yet)."""
        if self._httpd is None:
            self.start()
        self._thread.join()

    def close(self) -> None:
        """Stop the HTTP loop and the lanes. Safe to call more than once and
        from several threads at a time (``serve`` closes the daemon when
        ``serve_forever`` returns, which another thread's ``close`` causes):
        the first caller takes the HTTP server, the others find none."""
        with self._lane_lock:
            httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        with self._lane_lock:
            lanes = list(self._lanes.values())
            self._lanes.clear()
        for lane in lanes:
            lane.close()


def serve(model, host: str = "127.0.0.1", port: int = 8000, **kw) -> UFMServer:
    """Start a daemon (non-blocking) and return it; ``.close()`` stops it."""
    server = UFMServer(model, host=host, port=port, **kw)
    server.start()
    return server
