"""mfu.train: the reference model's operations on one pair for the forward,
the loss and the backward (counted on the meta device) times the pairs
trained a second, over the card's 989 TFLOP/s bf16 dense peak, in %."""

from benchmark.harness.yardstick import PEAK_BF16_FLOPS, model_flops_per_pair


def read(run):
    if not run.pairs:
        return None
    return 100.0 * model_flops_per_pair(run.arch, train=True) * run.pairs / run.window_s / PEAK_BF16_FLOPS
