"""Set-up: process start to the window's start (build or load of the
kernels, weights, cluster, warm-up or warm stretch)."""


def read(run):
    return run.setup_s
