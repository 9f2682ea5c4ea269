"""train_pairs_per_s: pairs of every train step completed in the window, over
the window's seconds; the window ends with a synchronize."""


def read(run):
    return run.pairs / run.window_s
