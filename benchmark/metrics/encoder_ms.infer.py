"""encoder_ms.infer: the median device ms a replay between the ``net.encoder``
span's timing events in the captured graph."""

from benchmark.spans import device_ms


def read(run):
    return device_ms(run, ["net.encoder"])
