"""mlp_fwd_roofline.infer: the summed bound of the traced stretch's fc1 + GELU
calls (M x 1024 -> 4096 at each encoder layer, M x 768 -> 3072 at each info
sharing layer, of each forward) over the summed device time of the kernel
that runs them (``linear_gelu_bf16_fwd_kernel``), in %."""

from benchmark.harness.yardstick import per_forward_bounds


def read(run):
    if run.stretch is None:
        return None
    seconds, count = run.stretch.kernel_s("linear_gelu_bf16_fwd_kernel")
    if not count:
        return None
    bound_ms = per_forward_bounds(run.arch, run.batch)["mlp_fwd"] * len(run.stretch_batches)
    return 100.0 * bound_ms / 1e3 / seconds
