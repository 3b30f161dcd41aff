"""The window's wall time over the model steps completed in it, in µs a step:
every call of the window, the cards synchronised at its end (host clock over
the whole window)."""


def read(run):
    return run.window_s / run.steps * 1e6 if run.steps else None
