"""refine_ms.infer: the median device ms a replay between the ``net.refine``
span's timing events in the captured graph (``UFMNet.refine_tail``)."""

from benchmark.spans import device_ms


def read(run):
    return device_ms(run, ["net.refine"])
