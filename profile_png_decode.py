#!/usr/bin/env python3
"""Host time of the port's PNG reader (``ufm_torch/utils/image_io.py``)
against ``cv2.imdecode`` on the same files.

    python3 profile_png_decode.py [--reps 5]

At the served and training sizes (480x640, 540x960, 1080x1920) it makes a
seeded RGB image (smooth gradients plus noise, like a photograph's rows)
and times the median of ``--reps`` decodes of:

- the file the port's writer makes (every row filter None);
- the file ``cv2.imencode`` makes (libpng's adaptive filters; the row
  filters it chose are printed), by the port and, where installed, by cv2;
- the worst case: the same bytes with every row marked Paeth, through the
  reader's unfiltering step alone (anti-diagonal steps over the whole image).

Prints one JSON line per size, then the host's CPU model. Needs no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import sys
import tempfile
import time
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ufm_torch.utils import image_io  # noqa: E402

SIZES = ((480, 640), (540, 960), (1080, 1920))


def _median_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return statistics.median(times) * 1e3


def _image(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([128 + 100 * np.sin(x / 97 + c) * np.cos(y / 61 - c) for c in range(3)], axis=2)
    return np.clip(base + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    try:
        import cv2
    except ImportError:
        cv2 = None
    for h, w in SIZES:
        rgb = _image(h, w, seed=h)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "port.png")
            image_io.write_png(path, rgb)
            with open(path, "rb") as f:
                port_file = f.read()
        row = {"hw": [h, w], "port_file_ms": _median_ms(lambda: image_io.decode_png(port_file), args.reps)}
        if cv2 is not None:
            cv2_file = cv2.imencode(".png", rgb[..., ::-1])[1].tobytes()
            filters = np.frombuffer(zlib.decompress(b"".join(
                b for k, b in image_io._chunks(cv2_file, "cv2") if k == b"IDAT")), np.uint8)[::3 * w + 1]
            buf = np.frombuffer(cv2_file, np.uint8)
            row.update(
                cv2_file_filters=np.bincount(filters, minlength=5).tolist(),
                cv2_file_ms=_median_ms(lambda: image_io.decode_png(cv2_file), args.reps),
                cv2_file_cv2_ms=_median_ms(lambda: cv2.imdecode(buf, cv2.IMREAD_COLOR), args.reps),
                port_file_cv2_ms=_median_ms(
                    lambda: cv2.imdecode(np.frombuffer(port_file, np.uint8), cv2.IMREAD_COLOR), args.reps))
        raw = np.zeros((h, w, 3), np.uint8)
        paeth = np.full(h, 4, np.uint8)
        row["all_paeth_unfilter_ms"] = _median_ms(lambda: image_io._unfilter(raw, paeth, 3), max(1, args.reps // 2))
        print(json.dumps(row), flush=True)
    print(json.dumps({"host_cpu": _cpu_model(), "cores": os.cpu_count(), "cv2": None if cv2 is None else cv2.__version__,
                      "numpy": np.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
