"""staging_ms.infer: the median host ms of ``predict.staging``: the wait for the
staging buffers, the copy into pinned memory, the host-to-device enqueue."""

from benchmark.spans import host_ms


def read(run):
    return host_ms(run, "predict.staging")
