"""The FVM nabla's share of its memory roofline, in %: the compulsory bytes of
a call (``pnabla_bytes``) at the card's published peak, over the device's
busy time a call in the traced calls (every operation of the trace).
Named after the operator, so it reads whatever kernel serves it; read only
from a trace that holds every launch of the port's kernels."""


def pnabla_bytes(nv: int, nk: int, ne: int, itemsize: int = 4, index_itemsize: int = 8,
                 components: int = 2) -> int:
    """``pp`` read once and each component's output written once (nv x nk
    each), each component's dual face read once (ne), ``sign`` (4 a vertex)
    and ``vol`` once, and the ``E2V`` (2 an edge) and ``V2E`` (4 a vertex)
    tables once. With ``components`` 1, ``index_itemsize`` 0 and ``nk`` 1 it
    is bench_torch.nabla_bytes, the x component's."""
    fields = (1 + components) * nv * nk + components * ne + 4 * nv + nv
    return fields * itemsize + (2 * ne + 4 * nv) * index_itemsize


def read(run):
    t = run.trace
    config = run.config
    if config["program"] != "fvm_pnabla" or not t or not t["complete"] or not run.peak_Bps:
        return None
    if t["busy_s"] <= 0:
        return None
    step_bytes = pnabla_bytes(config["columns"], config["levels"], config["edges"],
                              run.itemsize)
    return 100.0 * step_bytes / run.peak_Bps / (t["busy_s"] / t["steps"])
