"""prepare_ms.infer: the median host ms of ``predict.prepare``: the inputs'
layout (``_to_bchw``), the dtype checks and the program lookup under the
predict lock."""

from benchmark.spans import host_ms


def read(run):
    return host_ms(run, "predict.prepare")
