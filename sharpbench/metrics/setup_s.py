"""Process start to the first timed request: imports, the kernels'
libraries (built by nvcc on a checkout's first run), weights drawn on
the card, warm-up of the cell's own shapes."""


def read(run):
    return run.setup_s
