"""call_span_ms.infer: the median host ms of the program's ``predict.call`` span
over the traced stretch's calls: the whole public call, numpy in to outputs
enqueued (the in-program twin of ``call_host_ms.infer``)."""

from benchmark.spans import host_ms


def read(run):
    return host_ms(run, "predict.call")
