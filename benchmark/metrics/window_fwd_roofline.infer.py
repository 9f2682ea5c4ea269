"""window_fwd_roofline.infer: the summed bound of the traced stretch's window
refinement forwards, each counting the in-image taps that its pairs'
regression flow (from the reference) needs, over the summed device time of
the window kernels (``window_refinement_fwd*_kernel``), in %."""

from benchmark.harness.yardstick import window_bound_ms


def read(run):
    if run.stretch is None or not run.window_taps:
        return None
    seconds, count = run.stretch.kernel_s(r"window_refinement_fwd\w*_kernel")
    if not count:
        return None
    h, w = run.arch.model_hw
    shape = (run.batch, h, w, run.arch.cls_head["output_dim"])
    bound_ms = sum(window_bound_ms(shape, run.arch.patch, run.window_taps[b])[0] for b in run.stretch_batches)
    return 100.0 * bound_ms / 1e3 / seconds
