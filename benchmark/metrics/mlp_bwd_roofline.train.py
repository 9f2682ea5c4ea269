"""mlp_bwd_roofline.train: the summed bound of the traced stretch's fc2
input gradients with the GELU gradient (36 a step) over the summed device
time of the kernel that runs them (``linear_gelu_bf16_bwd_kernel``), in %."""

from benchmark.harness.yardstick import per_forward_bounds


def read(run):
    if run.stretch is None:
        return None
    seconds, count = run.stretch.kernel_s("linear_gelu_bf16_bwd_kernel")
    if not count:
        return None
    bound_ms = per_forward_bounds(run.arch, run.batch)["mlp_bwd"] * run.stretch.units
    return 100.0 * bound_ms / 1e3 / seconds
