#!/usr/bin/env python3
"""Command line for the PyTorch / CUDA port (counterpart of ``ufm_tpu/cli.py``).

    python -m ufm_torch.cli infer SOURCE TARGET (--checkpoint DIR | --random-init) [--model {base,refine}] [-o DIR] [--device cpu]
    python -m ufm_torch.cli eval DIR (--checkpoint DIR | --random-init) [--model {base,refine}] [--tiled] [-o JSON] [--device cpu]
    python -m ufm_torch.cli serve (--checkpoint DIR | --random-init) [--model {base,refine}] [--host H] [--port P] [--max-batch N] [--max-delay-ms MS] [--device cpu]
    python -m ufm_torch.cli test

``infer`` runs UFM-Base (``--model base``, the default) or UFM-Refine
(``--model refine``) on an image pair and writes ``flow_visualization.png``,
``covisibility_mask.png`` and ``warped_source.png``. ``eval`` scores a
directory of pairs (``name_0.png`` / ``name_1.png`` with ``name_flow.npy``,
``name.flo`` or ``name_flow.png`` ground truth; pairs without it by
forward-backward cycle consistency), optionally with tiled high-resolution
inference. Weights come from a local checkpoint directory (``--checkpoint``:
``config.json`` plus ``params.msgpack``, ``model.safetensors`` or
``pytorch_model.bin``) or are seeded random weights (``--random-init``).
``serve`` runs the HTTP daemon (``ufm_torch.runtime.server``: ``GET
/healthz``, ``GET /stats``, ``POST /v1/predict``) with continuous batching
per input-shape lane; each lane's batches are padded to ``--max-batch``, so
each lane replays one captured predict program. All three run on the GPU
unless ``--device cpu`` is given. ``test`` is an environment check.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

OUTPUT_FILES = ("flow_visualization.png", "covisibility_mask.png", "warped_source.png")


def _fail(msg: str) -> None:
    print(msg)
    sys.exit(1)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="ufm_torch", description="UFM dense correspondence, PyTorch / CUDA port"
    )
    sub = parser.add_subparsers(dest="command", help="Available commands")

    infer = sub.add_parser("infer", help="Run UFM on an image pair")
    infer.add_argument("source", help="Source image path")
    infer.add_argument("target", help="Target image path")
    infer.add_argument("--output", "-o", help="Output directory (default: current directory)")
    _add_model_arguments(infer)

    ev = sub.add_parser("eval", help="Evaluate on a directory of pairs (with or without ground-truth flow)")
    ev.add_argument("directory", help="Directory of name_0.png/name_1.png + name_flow.npy|.flo|_flow.png")
    _add_model_arguments(ev)
    ev.add_argument("--tiled", action="store_true", help="Coarse-to-fine tiled high-resolution inference")
    ev.add_argument("--output", "-o", help="Write aggregate + per-pair metrics JSON here")

    srv = sub.add_parser("serve", help="Run the HTTP serving daemon")
    srv.add_argument("--host", default="127.0.0.1")
    srv.add_argument("--port", type=int, default=8000)
    _add_model_arguments(srv)
    srv.add_argument(
        "--max-batch",
        type=int,
        default=4,
        help="Continuous-batching lane width (short batches are padded to this, so each lane "
        "replays one captured program; 1 disables coalescing)",
    )
    srv.add_argument("--max-delay-ms", type=float, default=3.0, help="Batching window before dispatch")

    sub.add_parser("test", help="Test installation")
    return parser


def _add_model_arguments(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--model", choices=("base", "refine"), default="base", help="UFM-Base or UFM-Refine (default: base)"
    )
    p.add_argument("--checkpoint", help="Local checkpoint directory (config.json + weights)")
    p.add_argument(
        "--random-init",
        action="store_true",
        help="Run with seeded random weights (pipeline smoke test; no checkpoint needed)",
    )
    p.add_argument("--device", default=None, help="torch device (default: cuda)")


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    handler = {"infer": run_inference, "eval": run_eval, "serve": run_serve, "test": lambda _: test_installation()}.get(
        args.command
    )
    if handler is None:
        parser.print_help()
        return
    handler(args)


def _read_rgb(path: str):
    import cv2

    bgr = cv2.imread(path)
    return None if bgr is None else cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def _write_rgb(path: Path, rgb) -> None:
    import cv2

    cv2.imwrite(str(path), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))


def _load_model(args):
    """The model of ``--model`` from ``--checkpoint`` or with seeded random
    weights (``--random-init``), on ``--device``."""
    from ufm_torch.models import (
        UniFlowMatchClassificationRefinement,
        UniFlowMatchConfidence,
        ufm_base_config,
        ufm_refine_config,
    )

    cls = UniFlowMatchClassificationRefinement if args.model == "refine" else UniFlowMatchConfidence
    if args.checkpoint:
        return cls.from_pretrained(args.checkpoint, device=args.device)
    config = ufm_refine_config() if args.model == "refine" else ufm_base_config()
    return cls.from_config(config, seed=0, device=args.device)


def _check_weights_given(args) -> None:
    if not args.checkpoint and not args.random_init:
        _fail("Error: pass --checkpoint DIR (a local checkpoint directory) or --random-init")


def run_inference(args) -> None:
    _check_weights_given(args)
    try:
        import numpy as np

        from ufm_torch.utils.viz import flow_to_color, warp_image_with_flow
    except ImportError as e:
        _fail(f"Error importing dependencies: {e}")

    source_rgb = _read_rgb(args.source)
    target_rgb = _read_rgb(args.target)
    if source_rgb is None or target_rgb is None:
        _fail(f"Error: could not read {args.source if source_rgb is None else args.target}")

    try:
        model = _load_model(args)
    except (OSError, ImportError, KeyError, RuntimeError, ValueError) as e:
        _fail(f"Error loading model: {e}")
    try:
        print(f"Running inference on {model.device}...")
        result = model.predict_correspondences_batched(source_image=source_rgb, target_image=target_rgb)
    except (RuntimeError, ValueError) as e:
        _fail(f"Error during inference: {e}")

    flow_hwc = result.flow.flow_output[0].permute(1, 2, 0).cpu().numpy()
    covis = result.covisibility.mask[0].cpu().numpy()

    out_dir = Path(args.output) if args.output else Path.cwd()
    out_dir.mkdir(exist_ok=True)

    # Backward-warp the target into the source frame, whiting out non-covisible
    # pixels so occlusions read as "no correspondence" in the panel.
    warped = warp_image_with_flow(source_rgb, None, target_rgb, flow_hwc).astype(np.float32)
    alpha = covis[..., None]
    composite = (alpha * warped + (1.0 - alpha) * 255.0).astype(np.uint8)

    _write_rgb(out_dir / OUTPUT_FILES[0], flow_to_color(flow_hwc))
    _write_rgb(out_dir / OUTPUT_FILES[1], np.repeat((covis * 255).astype(np.uint8)[..., None], 3, axis=-1))
    _write_rgb(out_dir / OUTPUT_FILES[2], composite)

    print(f"Wrote {len(OUTPUT_FILES)} files to {out_dir}:")
    for name in OUTPUT_FILES:
        print(f"  {name}")


def run_eval(args) -> None:
    from ufm_torch.eval import evaluate_pairs, find_pairs

    _check_weights_given(args)
    if not Path(args.directory).is_dir():
        _fail(f"Error: not a directory: {args.directory}")
    if not any(True for _ in find_pairs(args.directory, require_gt=False)):
        _fail(
            f"Error: no evaluable pairs in {args.directory} "
            "(expected name_0.png/name_1.png, optionally with name_flow.npy, name.flo or name_flow.png ground truth)"
        )
    try:
        model = _load_model(args)
    except (OSError, ImportError, KeyError, RuntimeError, ValueError) as e:
        _fail(f"Error loading model: {e}")
    # pairs without ground truth are scored by forward-backward cycle consistency
    agg = evaluate_pairs(model, args.directory, tiled=args.tiled, out_json=args.output, require_gt=False)
    for k in (
        "epe", "epe_median", "acc_1px", "acc_3px", "acc_5px", "fl_outlier",
        "cycle_epe", "cycle_epe_median", "cycle_acc_1px", "cycle_acc_3px",
        "cycle_coverage", "covis_mean",
    ):
        if k in agg:
            print(f"{k}: {agg[k]:.4f}")
    print(f"pairs: {int(agg.get('num_pairs', 0))} (all flows finite: {agg.get('all_flows_finite')})")
    if args.output:
        print(f"Wrote metrics to {args.output}")


def run_serve(args) -> None:
    _check_weights_given(args)
    if args.max_batch < 1:
        _fail(f"Error: --max-batch must be at least 1, got {args.max_batch}")
    try:
        model = _load_model(args)
    except (OSError, ImportError, KeyError, RuntimeError, ValueError) as e:
        _fail(f"Error loading model: {e}")
    from ufm_torch.runtime.server import UFMServer

    server = UFMServer(model, host=args.host, port=args.port, max_batch=args.max_batch, max_delay_ms=args.max_delay_ms)
    try:
        server.start()
    except OSError as e:
        _fail(f"Error: cannot listen on {args.host}:{args.port}: {e}")
    source = args.checkpoint or "seeded random weights"
    print(f"Serving {type(model).__name__} ({source}) on {model.device} at http://{args.host}:{server.port}", flush=True)
    print("  GET /healthz | GET /stats | POST /v1/predict (npz or JSON, see ufm_torch/runtime/server.py)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


def test_installation() -> None:
    print("Testing ufm_torch installation...")
    failures = []

    def probe(label, fn, required=True):
        try:
            detail = fn()
            print(f"+ {label}" + (f" {detail}" if detail else ""))
        except Exception as e:  # noqa: BLE001 — a smoke check reports, never raises
            mark = "x" if required else "!"
            print(f"{mark} {label}: {e}")
            if required:
                failures.append(label)

    probe("PyTorch", lambda: __import__("torch").__version__)
    probe("NumPy", lambda: __import__("numpy").__version__)
    probe("OpenCV (CLI image IO)", lambda: __import__("cv2").__version__, required=False)

    def _import_models():
        from ufm_torch.models import UniFlowMatchConfidence  # noqa: F401

    probe("ufm_torch model imports", _import_models)

    def _gpu():
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (the port runs on the GPU; --device cpu for the CPU)")
        return f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"

    probe("GPU", _gpu, required=False)

    def _nvcc():
        from ufm_torch.ops._build import _nvcc as find

        return find()

    probe("nvcc (builds the CUDA kernels on first use)", _nvcc, required=False)

    if failures:
        _fail(f"\nInstallation test FAILED: {', '.join(failures)}")
    print("\nInstallation test completed successfully!")


if __name__ == "__main__":
    main()
