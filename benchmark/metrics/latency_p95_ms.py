"""latency_p95_ms: the 95th percentile over every call in the window of the
host clock from the call (numpy in) until its outputs are complete on the
card (a synchronize)."""

from benchmark.harness.yardstick import percentile


def read(run):
    return percentile(run.latency_ms, 95) if run.latency_ms else None
