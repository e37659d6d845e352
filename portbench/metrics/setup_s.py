"""Seconds from the process's start to the window's opening: the imports,
the data, the index build, loading (at a checkout's first run, building)
the kernels, and the warm-up requests."""


def read(run):
    return run.setup_s
