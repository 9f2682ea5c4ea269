"""call_host_ms.infer: the median over the window's calls of the host clock
from the call to its return, before the synchronize: input staging and the
captured program's replay enqueued."""

import statistics


def read(run):
    return statistics.median(run.host_ms) if run.host_ms else None
