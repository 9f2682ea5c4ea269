"""idle_share: the share of the traced stretch's host-clock length in which
no operation ran on the card (busy time is the union of the device
intervals in the profiler's trace), in %."""


def read(run):
    if run.stretch is None:
        return None
    return 100.0 * (1.0 - run.stretch.busy_s() / run.stretch.window_s)
