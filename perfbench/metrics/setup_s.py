"""Seconds from the start of ``run.py`` to the window's first call: importing
torch and the port, the card's context, the inputs, the stencil's build (and
``nvcc`` on a cold cache), the entry's fields, the warm-up calls and the
CUDA events of the window."""


def read(run):
    return run.setup_s
