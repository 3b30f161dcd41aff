"""The 95th percentile, over every call of the window, of the time between the
completions of consecutive calls, in µs, read on the cards' clocks (a CUDA
event after each call; on a mesh, the longest over the cards)."""

import numpy as np


def read(run):
    return float(np.percentile(run.intervals_us, 95)) if run.intervals_us else None
