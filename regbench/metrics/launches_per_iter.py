"""Kernel launches on the card (kernel records of the device trace; copies
and fills left out) over the traced window's ICP iterations."""


def read(run):
    tr = run.trace
    if tr is None or not tr.iterations or not tr.kernels:
        return None
    return len(tr.kernels) / tr.iterations
