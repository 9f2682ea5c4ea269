"""optimizer_ms.train: the median over the traced run's window of the
CUDA-event time around the optimizer's step (clip, AdamW on the fp32
masters, write-back)."""

import statistics


def read(run):
    return statistics.median(run.optimizer_ms) if run.optimizer_ms else None
