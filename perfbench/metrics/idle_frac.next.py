"""The device's idle share of the traced calls: 1 - (the union of the trace's
device operations on a card, averaged over the cards) / the traced window."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
