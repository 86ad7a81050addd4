"""setup_s: Set-up seconds: process start to the end of the warm-up (inputs
made, kernels built, first calls run)."""


def read(run):
    return run.setup_s
