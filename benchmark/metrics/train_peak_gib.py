"""train_peak_gib: ``torch.cuda.max_memory_allocated()`` over the window,
after a reset at its start, in GiB."""


def read(run):
    return run.window_peak_bytes / 2**30 if run.window_peak_bytes else None
