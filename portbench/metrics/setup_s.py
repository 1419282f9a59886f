"""Process start to the first timed request (host clock): imports, the
kernel library, inputs made from the seed, and the warm-up requests."""


def read(run):
    return run.setup_s
