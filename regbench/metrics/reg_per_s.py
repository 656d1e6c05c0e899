"""Registrations completed in the window over the window's seconds."""


def read(run):
    w = run.window
    return len(w.latencies) / w.seconds if w.latencies and w.seconds > 0 else None
