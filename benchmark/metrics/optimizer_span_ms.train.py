"""optimizer_span_ms.train: the median device ms a traced step of
``train.optimizer`` (clip, AdamW on the fp32 masters, write-back), between its
span's CUDA events (the in-program twin of ``optimizer_ms.train``)."""

from benchmark.spans import device_ms


def read(run):
    return device_ms(run, ["train.optimizer"])
