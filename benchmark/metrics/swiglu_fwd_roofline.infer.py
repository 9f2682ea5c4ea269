"""swiglu_fwd_roofline.infer: the summed bound of the traced stretch's SwiGLU
``w12`` + gate calls (M = 2B x the encoder's tokens, 1536 -> 2 x 4096 at each
ViT-g block of each forward) over the summed device time of the kernel that
runs them (``linear_swiglu_bf16_fwd_kernel``), in %; nothing where the
kernel did not run."""

from benchmark.harness.swiglu import swiglu_fwd_bound_ms


def read(run):
    if run.stretch is None:
        return None
    seconds, count = run.stretch.kernel_s("linear_swiglu_bf16_fwd_kernel")
    bound_ms = swiglu_fwd_bound_ms(run.arch, run.batch)
    if not count or bound_ms is None:
        return None
    return 100.0 * bound_ms * len(run.stretch_batches) / 1e3 / seconds
