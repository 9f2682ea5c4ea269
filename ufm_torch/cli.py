#!/usr/bin/env python3
"""Command line for the PyTorch / CUDA port (counterpart of ``ufm_tpu/cli.py``).

    python -m ufm_torch.cli infer SOURCE TARGET (--checkpoint DIR | --random-init | --artifact PATH) [--model {base,refine,base-vitg-reg}] [-o DIR] [--device cpu]
    python -m ufm_torch.cli eval DIR (--checkpoint DIR | --random-init) [--model {base,refine,base-vitg-reg}] [--tiled] [-o JSON] [--device cpu]
    python -m ufm_torch.cli export OUTPUT (--checkpoint DIR | --random-init) [--model {base,refine,base-vitg-reg}] [--batch N] [--params-dtype {bfloat16,float16}] [--device cpu]
    python -m ufm_torch.cli serve (--checkpoint DIR | --random-init | --artifact PATH) [--model {base,refine,base-vitg-reg}] [--host H] [--port P] [--max-batch N] [--max-delay-ms MS] [--device cpu]
    python -m ufm_torch.cli demo [--checkpoint DIR] [--model {base,refine}] [--port P] [--share] [--device cpu]
    python -m ufm_torch.cli test

``infer`` runs UFM-Base (``--model base``, the default), UFM-Refine
(``--model refine``) or UFM-Base's heads on DINOv2 ViT-g/14 with registers
(``--model base-vitg-reg``, :func:`ufm_torch.models.ufm_base_vitg_reg_config`)
on an image pair and writes ``flow_visualization.png``,
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
each lane replays one captured predict program. ``export`` writes a
deployment artifact (``ufm_torch.runtime.export``: a fixed-shape
``torch.export`` program of the network with its parameters beside it, one
``.ufmt`` file); ``infer --artifact`` and ``serve --artifact`` run one in
place of a live model (``serve`` pins ``--max-batch`` to the artifact's
batch). ``demo`` runs the gradio app (``ufm_torch.demo``; needs ``gradio``).
All of them run on the GPU unless ``--device cpu`` is given. ``test`` is an
environment check.
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
    _add_model_arguments(infer, artifact=True)

    ev = sub.add_parser("eval", help="Evaluate on a directory of pairs (with or without ground-truth flow)")
    ev.add_argument("directory", help="Directory of name_0.png/name_1.png + name_flow.npy|.flo|_flow.png")
    _add_model_arguments(ev)
    ev.add_argument("--tiled", action="store_true", help="Coarse-to-fine tiled high-resolution inference")
    ev.add_argument("--output", "-o", help="Write aggregate + per-pair metrics JSON here")

    exp = sub.add_parser("export", help="Write a deployment artifact (torch.export program + parameters, .ufmt)")
    exp.add_argument("output", help="Artifact path (suffix .ufmt)")
    _add_model_arguments(exp)
    exp.add_argument("--batch", type=int, default=1, help="Fixed batch size of the exported program")
    exp.add_argument(
        "--params-dtype",
        choices=("bfloat16", "float16"),
        default=None,
        help="Store floating parameters in half precision (cast back on load)",
    )

    srv = sub.add_parser("serve", help="Run the HTTP serving daemon (live model or artifact)")
    srv.add_argument("--host", default="127.0.0.1")
    srv.add_argument("--port", type=int, default=8000)
    _add_model_arguments(srv, artifact=True)
    srv.add_argument(
        "--max-batch",
        type=int,
        default=4,
        help="Continuous-batching lane width (short batches are padded to this, so each lane "
        "replays one captured program; 1 disables coalescing)",
    )
    srv.add_argument("--max-delay-ms", type=float, default=3.0, help="Batching window before dispatch")

    demo = sub.add_parser("demo", help="Launch the interactive gradio demo")
    demo.add_argument("--port", type=int, default=7860, help="Port to run the demo on (default: 7860)")
    demo.add_argument("--share", action="store_true", help="Create a public sharing link")
    demo.add_argument(
        "--model", choices=("base", "refine"), default="base", help="UFM-Base or UFM-Refine (default: base)"
    )
    demo.add_argument("--checkpoint", help="Local checkpoint directory (default: seeded random weights)")
    demo.add_argument("--device", default=None, help="torch device (default: cuda)")

    sub.add_parser("test", help="Test installation")
    return parser


def _add_model_arguments(p: argparse.ArgumentParser, artifact: bool = False) -> None:
    p.add_argument(
        "--model", choices=("base", "refine", "base-vitg-reg"), default="base",
        help="UFM-Base, UFM-Refine, or UFM-Base on DINOv2 ViT-g/14 with registers (default: base)",
    )
    p.add_argument("--checkpoint", help="Local checkpoint directory (config.json + weights)")
    p.add_argument(
        "--random-init",
        action="store_true",
        help="Run with seeded random weights (pipeline smoke test; no checkpoint needed)",
    )
    if artifact:
        p.add_argument("--artifact", help="Run a deployment artifact (cli export) in place of a live model")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    handler = {
        "infer": run_inference,
        "eval": run_eval,
        "export": run_export,
        "serve": run_serve,
        "demo": run_demo,
        "test": lambda _: test_installation(),
    }.get(args.command)
    if handler is None:
        parser.print_help()
        return
    handler(args)


def _read_rgb(path: str):
    """The image at ``path`` as RGB uint8 (PNG by the port's codec, other
    formats by cv2), or None when it cannot be read; why goes to stderr."""
    from ufm_torch.utils.image_io import read_rgb

    try:
        return read_rgb(path)
    except (OSError, ValueError, ImportError) as e:
        print(f"{path}: {e}", file=sys.stderr)
        return None


def _load_model(args):
    """The artifact of ``--artifact`` in the predict API, else the model of
    ``--model`` from ``--checkpoint`` or with seeded random weights
    (``--random-init``), on ``--device``."""
    if getattr(args, "artifact", None):
        from ufm_torch.runtime.export import load_artifact_model

        return load_artifact_model(args.artifact, device=args.device)
    from ufm_torch.models import (
        UniFlowMatchClassificationRefinement,
        UniFlowMatchConfidence,
        ufm_base_config,
        ufm_base_vitg_reg_config,
        ufm_refine_config,
    )

    cls = UniFlowMatchClassificationRefinement if args.model == "refine" else UniFlowMatchConfidence
    if args.checkpoint:
        return cls.from_pretrained(args.checkpoint, device=args.device)
    config = {"base": ufm_base_config, "refine": ufm_refine_config,
              "base-vitg-reg": ufm_base_vitg_reg_config}[args.model]()
    return cls.from_config(config, seed=0, device=args.device)


def _check_weights_given(args) -> None:
    if not args.checkpoint and not args.random_init and not getattr(args, "artifact", None):
        artifact = " or --artifact PATH" if hasattr(args, "artifact") else ""
        _fail(f"Error: pass --checkpoint DIR (a local checkpoint directory) or --random-init{artifact}")


def run_inference(args) -> None:
    _check_weights_given(args)
    try:
        from ufm_torch.utils.image_io import write_png
        from ufm_torch.utils.viz import correspondence_panels
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
    for name, panel in zip(OUTPUT_FILES, correspondence_panels(source_rgb, target_rgb, flow_hwc, covis)):
        write_png(str(out_dir / name), panel)

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

    max_batch = args.max_batch
    if args.artifact and max_batch != model.exported.batch:
        # an artifact's program is fixed-shape and every lane batch is padded
        # to max_batch: any other width would fail every request
        print(f"note: artifact was exported at fixed batch {model.exported.batch}; "
              f"using --max-batch {model.exported.batch} (requested {max_batch})", flush=True)
        max_batch = model.exported.batch
    server = UFMServer(model, host=args.host, port=args.port, max_batch=max_batch, max_delay_ms=args.max_delay_ms)
    try:
        server.start()
    except OSError as e:
        _fail(f"Error: cannot listen on {args.host}:{args.port}: {e}")
    source = args.artifact or args.checkpoint or "seeded random weights"
    print(f"Serving {type(model).__name__} ({source}) on {model.device} at http://{args.host}:{server.port}", flush=True)
    print("  GET /healthz | GET /stats | POST /v1/predict (npz or JSON, see ufm_torch/runtime/server.py)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


def run_export(args) -> None:
    _check_weights_given(args)
    if args.batch < 1:
        _fail(f"Error: --batch must be at least 1, got {args.batch}")
    try:
        model = _load_model(args)
    except (OSError, ImportError, KeyError, RuntimeError, ValueError) as e:
        _fail(f"Error loading model: {e}")
    from ufm_torch.runtime.export import export_model

    try:
        manifest = export_model(model, args.output, batch=args.batch, params_dtype=args.params_dtype)
    except (OSError, RuntimeError, ValueError) as e:
        _fail(f"Error exporting model: {e}")
    w, h = manifest["resolution_wh"]
    dtype = f", parameters stored in {manifest['params_dtype']}" if manifest["params_dtype"] else ""
    print(
        f"Exported {manifest['model_class']} (one program, batch {manifest['batch']}, {w}x{h}, traced on "
        f"{manifest['devices'][0]}{dtype}) -> {args.output} ({Path(args.output).stat().st_size / 1e6:.1f} MB; "
        f"program {manifest['program_bytes'] / 1e6:.1f} MB)"
    )


def run_demo(args) -> None:
    try:
        import gradio  # noqa: F401
    except ImportError as e:
        _fail(f"Error: the demo needs gradio, which is not installed ({e})")
    from ufm_torch.demo import create_demo, initialize_model

    print(f"Serving the {args.model} model at http://localhost:{args.port}")
    if not initialize_model(use_refinement=args.model == "refine", checkpoint=args.checkpoint, device=args.device):
        _fail("Error: the model failed to load (see above)")
    create_demo().launch(share=args.share, server_port=args.port, server_name="127.0.0.1", show_error=True)


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
    probe("OpenCV (non-PNG image files)", lambda: __import__("cv2").__version__, required=False)

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
