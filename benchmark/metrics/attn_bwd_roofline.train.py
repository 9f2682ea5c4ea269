"""attn_bwd_roofline.train: the summed bound of the traced stretch's
attention backward calls (36 a step: the encoder's 24 at 2B x 1201 tokens,
the info sharing's 12 at B x 2400) over the summed device time of the
kernels that run them (``attention_delta_kernel``, ``attention_grads_kernel``),
in %."""

from benchmark.harness.yardstick import per_forward_bounds


def read(run):
    if run.stretch is None:
        return None
    delta, n_delta = run.stretch.kernel_s("attention_delta_kernel")
    grads, n_grads = run.stretch.kernel_s("attention_grads_kernel")
    if not (n_delta or n_grads):
        return None
    bound_ms = per_forward_bounds(run.arch, run.batch)["attn_bwd"] * run.stretch.units
    return 100.0 * bound_ms / 1e3 / (delta + grads)
