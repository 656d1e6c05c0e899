"""Process start to the first timed request: imports, the card, the kernel
library (built on a checkout's first run), the cell's data and its
warm-up registrations."""


def read(run):
    return run.setup_s
