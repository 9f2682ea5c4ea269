"""step_host_ms.train: the median over the window's steps of the host clock
from the train step's call to its return, without a synchronize."""

import statistics


def read(run):
    return statistics.median(run.host_ms) if run.host_ms else None
