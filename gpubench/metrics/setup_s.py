"""Set-up: process start to the first timed call (host clock): imports,
the kernels' library (built on a checkout's first run), the batch and
weights made from the seed, and the warm-up calls."""


def read(run):
    return run.setup_s
