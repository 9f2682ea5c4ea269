"""setup_s: seconds from the process's start to the window's start (imports,
kernel loads or builds, weights, traffic, warm-up and capture)."""


def read(run):
    return run.setup_s
