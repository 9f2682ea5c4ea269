"""Gradio demo (counterpart of ``ufm_tpu/demo.py``).

A model singleton, reloaded when the variant changes; ``initialize_model``
and ``create_demo`` entry points; three outputs per pair (flow colorwheel,
covisibility, covisibility-gated warp: the panels of ``cli infer``);
processing on upload. Weights come from a local checkpoint directory or are
seeded random weights: nothing is downloaded. The model runs on the GPU
unless ``device="cpu"`` is given.

Needs ``gradio``, imported only by :func:`create_demo` (``cli demo`` reports
it missing).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

model = None
_loaded: Optional[tuple] = None  # (use_refinement, checkpoint, device) of ``model``


def initialize_model(use_refinement: bool = False, checkpoint: Optional[str] = None, device: Optional[str] = None) -> bool:
    """Load (or reload) the model singleton: UFM-Refine or UFM-Base from
    ``checkpoint`` (a local directory), else with seeded random weights, on
    ``device``. Returns whether a model is loaded."""
    global model, _loaded
    key = (use_refinement, checkpoint, device)
    if model is not None and _loaded == key:
        return True
    from ufm_torch.models import (
        UniFlowMatchClassificationRefinement,
        UniFlowMatchConfidence,
        ufm_base_config,
        ufm_refine_config,
    )

    cls = UniFlowMatchClassificationRefinement if use_refinement else UniFlowMatchConfidence
    try:
        if checkpoint:
            model = cls.from_pretrained(checkpoint, device=device)
        else:
            model = cls.from_config(ufm_refine_config() if use_refinement else ufm_base_config(), seed=0, device=device)
    except (OSError, ImportError, KeyError, RuntimeError, ValueError) as e:
        print(f"Failed to load model: {e}")
        model, _loaded = None, None
        return False
    _loaded = key
    print(f"Loaded {'UFM-Refine' if use_refinement else 'UFM-Base'} ({checkpoint or 'seeded random weights'}) on {model.device}")
    return True


def process_images(source_image, target_image, use_refinement: bool = False):
    """An RGB uint8 pair -> (flow colorwheel, covisibility, gated warp), or
    three Nones while an image is missing."""
    from ufm_torch.utils.viz import correspondence_panels

    if source_image is None or target_image is None:
        return None, None, None
    checkpoint, device = (_loaded[1], _loaded[2]) if _loaded else (None, None)
    if not initialize_model(use_refinement, checkpoint, device):
        raise RuntimeError("the model failed to load")
    src, tgt = np.asarray(source_image), np.asarray(target_image)
    result = model.predict_correspondences_batched(source_image=src, target_image=tgt)
    flow = result.flow.flow_output[0].permute(1, 2, 0).cpu().numpy()
    covis = result.covisibility.mask[0].cpu().numpy()
    return correspondence_panels(src, tgt, flow, covis)


def create_demo():
    """The gradio app: two image inputs, the refinement switch, three
    outputs, and the bundled example pairs where they can be generated."""
    import gradio as gr

    with gr.Blocks(title="UFM: Unified Flow & Matching") as demo:
        gr.Markdown("# UFM: dense correspondences (PyTorch / CUDA)")
        gr.Markdown("Upload a source/target image pair; outputs are computed automatically.")
        with gr.Row():
            source = gr.Image(label="Source Image", type="numpy")
            target = gr.Image(label="Target Image", type="numpy")
        use_refinement = gr.Checkbox(label="Use refinement model", value=False)
        with gr.Row():
            flow_out = gr.Image(label="Flow (colorwheel)")
            covis_out = gr.Image(label="Covisibility")
            warp_out = gr.Image(label="Warped target (covisibility-gated)")
        inputs = [source, target, use_refinement]
        outputs = [flow_out, covis_out, warp_out]
        source.upload(process_images, inputs, outputs)
        target.upload(process_images, inputs, outputs)
        use_refinement.change(process_images, inputs, outputs)
        examples = _bundled_example_pairs()
        if examples:
            gr.Examples(examples=examples, inputs=[source, target])
    return demo


def _bundled_example_pairs():
    """[source, target] paths of the reference photo pairs (where
    ``UFM_REFERENCE_PAIRS`` names them) and the generated synthetic pairs."""
    import glob
    import os

    from ufm_torch.utils.example_pairs import ensure_bundled_pairs, reference_pair_dir

    try:
        dirs = [d for d in (reference_pair_dir(), ensure_bundled_pairs()) if d]
    except (OSError, ImportError):  # no writable directory or no cv2: no examples
        return []
    pairs = []
    for pair_dir in dirs:
        for img0 in sorted(glob.glob(os.path.join(pair_dir, "*_0.png"))):
            img1 = img0[: -len("_0.png")] + "_1.png"
            if os.path.exists(img1):
                pairs.append([img0, img1])
    return pairs


def main() -> None:
    if not initialize_model():
        raise SystemExit(1)
    create_demo().launch()


if __name__ == "__main__":
    main()
