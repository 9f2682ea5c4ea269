"""forward_ms.train: the median device ms a traced step of ``train.forward`` plus
``train.loss``, each between its span's CUDA events."""

from benchmark.spans import device_ms


def read(run):
    return device_ms(run, ["train.forward", "train.loss"])
