"""Process start to window open: imports, the kernels' load (their nvcc
build on a checkout's first run), the data, prepare and the warm-up."""


def read(run):
    return run.setup_s
