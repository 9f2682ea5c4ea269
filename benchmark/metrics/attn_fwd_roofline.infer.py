"""attn_fwd_roofline.infer: the summed bound of the traced stretch's
attention-forward calls (the encoder's 2B x 1201 tokens and the info
sharing's B x 2400, at each layer of each forward) over the summed device
time of the kernels that run them (``flash_attention_fwd_kernel``), in %."""

from benchmark.harness.yardstick import per_forward_bounds


def read(run):
    if run.stretch is None:
        return None
    seconds, count = run.stretch.kernel_s("flash_attention_fwd_kernel")
    if not count:
        return None
    bound_ms = per_forward_bounds(run.arch, run.batch)["attn_fwd"] * len(run.stretch_batches)
    return 100.0 * bound_ms / 1e3 / seconds
