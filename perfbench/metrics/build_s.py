"""Seconds of ``gtscript.stencil(...)`` (the front end, the passes, the code
generator, and ``nvcc`` where the kernel's library is not in the cache yet),
the entry's fields and its first call, to the cards' synchronisation (host
clock)."""


def read(run):
    return run.build_s
