"""hdiff's share of its memory roofline, in %: the compulsory bytes of a step
(``hdiff_bytes``) at the card's published peak, over the device's busy time
a step in the traced calls (every operation of the trace: kernels, copies,
sets). Named after the stencil, so it reads whatever kernel serves hdiff;
read only from a trace that holds every launch of the port's kernels."""

import math


def hdiff_bytes(ni: int, nj: int, nk: int, halo: int, itemsize: int = 4) -> int:
    """in_field over the domain and its halo, coeff and out_field over the
    domain, each once (copied from bench_torch.py:205-208, after bench.py:260,
    :342)."""
    return ((ni + 2 * halo) * (nj + 2 * halo) + 2 * ni * nj) * nk * itemsize


def read(run):
    t = run.trace
    if run.config["program"] != "hdiff" or not t or not t["complete"] or not run.peak_Bps:
        return None
    if t["busy_s"] <= 0:
        return None
    ni, nj, nk = run.config["domain"]
    chips = math.prod(run.config["mesh"]) if run.config.get("mesh") else 1
    step_bytes = hdiff_bytes(ni, nj, nk, run.config["halo"], run.itemsize) / chips
    return 100.0 * step_bytes / run.peak_Bps / (t["busy_s"] / t["steps"])
