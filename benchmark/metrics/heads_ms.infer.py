"""heads_ms.infer: the median device ms a replay between the ``net.heads`` span's
timing events in the captured graph (everything in ``UFMNet.backbone`` after
info sharing)."""

from benchmark.spans import device_ms


def read(run):
    return device_ms(run, ["net.heads"])
