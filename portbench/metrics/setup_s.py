"""setup_s: process start to the window's first timed operation (weights,
warm-up and, on a checkout's first run, the nvcc builds)."""


def read(run):
    return None if run.window_start is None else run.setup_s
