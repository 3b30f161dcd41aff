"""vadv's share of its memory roofline, in %: the compulsory bytes of a step
(``vadv_bytes``) at the card's published peak, over the device's busy time
a step in the traced calls (every operation of the trace). Named after the
stencil, so it reads whatever kernel serves vadv; read only from a trace
that holds every launch of the port's kernels."""


def vadv_points(ni: int, nj: int, nk: int) -> int:
    """vadv's domain, one point short in I (copied from bench_torch.py:211-213,
    after bench.py:449)."""
    return (ni - 1) * nj * nk


def vadv_bytes(ni: int, nj: int, nk: int, itemsize: int = 4) -> int:
    """5 reads and 1 write a point (copied from bench_torch.py:216-218, after
    bench.py:452)."""
    return 6 * vadv_points(ni, nj, nk) * itemsize


def read(run):
    t = run.trace
    if run.config["program"] != "vadv" or not t or not t["complete"] or not run.peak_Bps:
        return None
    if t["busy_s"] <= 0 or run.config.get("mesh"):
        return None
    ni, nj, nk = run.config["fields"]["utens_stage"]["shape"]
    step_bytes = vadv_bytes(ni, nj, nk, run.itemsize)
    return 100.0 * step_bytes / run.peak_Bps / (t["busy_s"] / t["steps"])
