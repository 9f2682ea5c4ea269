"""step_span_ms.train: the median host ms of the program's ``train.step`` span
over the traced stretch's steps, without a synchronize (the in-program twin of
``step_host_ms.train``)."""

from benchmark.spans import host_ms


def read(run):
    return host_ms(run, "train.step")
