"""pairs_per_s: image pairs answered with finite outputs in the window, over
the window's seconds."""


def read(run):
    return run.pairs / run.window_s
