"""idle_named_share.infer: the share (%) of the traced stretch's idle device time
(the gaps between its device intervals) that lies inside one of the program's
``predict.*`` spans."""

from benchmark.spans import named_idle_share


def read(run):
    return named_idle_share(run, "predict.")
