"""launch_ms.infer: the median host ms of ``predict.launch``: the captured
graph's replay (``cudaGraphLaunch``)."""

from benchmark.spans import host_ms


def read(run):
    return host_ms(run, "predict.launch")
