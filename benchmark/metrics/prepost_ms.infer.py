"""prepost_ms.infer: the median device ms a replay of ``predict.pre`` (normalize,
resize) plus ``predict.post`` (unmap), each between its timing events in the
captured graph."""

from benchmark.spans import device_ms


def read(run):
    return device_ms(run, ["predict.pre", "predict.post"])
