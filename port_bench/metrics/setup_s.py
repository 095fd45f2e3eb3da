"""setup_s: process start to the window: imports, the kernels' libraries, weights and inputs, warm-up."""


def read(run):
    return run.setup_s
