"""backward_ms.train: the median device ms a traced step of ``train.backward``,
between its span's CUDA events."""

from benchmark.spans import device_ms


def read(run):
    return device_ms(run, ["train.backward"])
