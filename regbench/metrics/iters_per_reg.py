"""Mean ``result.iters`` of the traced window's registrations: the
solver's iterations to converge."""


def read(run):
    tr = run.trace
    if tr is None or not tr.registrations:
        return None
    return tr.iterations / len(tr.registrations)
