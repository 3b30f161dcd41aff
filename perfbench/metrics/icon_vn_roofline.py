"""ICON's vn diffusion step's share of its memory roofline, in %: the
step's compulsory bytes (``step_bytes``) at the card's published peak, over
the device's busy time a step in the traced calls (every operation of the
trace). Named after the step, so it reads whatever kernels serve it; read
only from a trace that holds every launch of the port's kernels.

Compulsory: each field, table and geometry array read or written once by
each call that touches it (the byte counts of the step's operators below,
each in ``itemsize`` bytes a value and ``index_itemsize`` an index).
"""


def rbf_bytes(nv: int, ne: int, nk: int, itemsize: int = 8, index_itemsize: int = 8) -> int:
    """Operator 1: the edge field read (ne x nk), both coefficient fields
    (6 a vertex each) and ``V2E`` (6 a vertex), u and v written (nv x nk
    each)."""
    return (ne * nk + 2 * 6 * nv + 2 * nv * nk) * itemsize + 6 * nv * index_itemsize


def nabla2_bytes(nv: int, ne: int, nk: int, itemsize: int = 8, index_itemsize: int = 8) -> int:
    """Operator 2: ``u_vert``, ``v_vert`` (nv x nk each), ``vn`` and three
    outputs (ne x nk each), four normals over ECV (4 an edge each), three
    edge arrays, two profiles over K, ``E2C2V`` and ``E2ECV`` (4 an edge
    each)."""
    return (2 * nv * nk + 4 * ne * nk + 16 * ne + 3 * ne + 2 * nk) * itemsize \
        + 8 * ne * index_itemsize


def nabla4_bytes(nv: int, ne: int, nk: int, itemsize: int = 8, index_itemsize: int = 8) -> int:
    """Operator 3: ``u_vert``, ``v_vert``, ``z_nabla2_e`` read, ``z_nabla4_e2``
    written, two primal normals over ECV, two edge arrays, ``E2C2V`` and
    ``E2ECV``."""
    return (2 * nv * nk + 2 * ne * nk + 8 * ne + 2 * ne) * itemsize + 8 * ne * index_itemsize


def apply_bytes(nv: int, ne: int, nk: int, itemsize: int = 8, index_itemsize: int = 8) -> int:
    """Operator 4: ``kh_smag_e``, ``z_nabla2_e``, ``z_nabla4_e2`` and ``vn``
    read, ``vn`` written (ne x nk each), ``area_edge`` and ``nudgecoeff_e``,
    one profile over K; no table."""
    return (5 * ne * nk + 2 * ne + nk) * itemsize


def step_bytes(nv: int, ne: int, nk: int, itemsize: int = 8, index_itemsize: int = 8) -> int:
    """The step: operator 1 twice, then 2, 3 and 4."""
    return sum(f(nv, ne, nk, itemsize, index_itemsize) for f in (
        rbf_bytes, rbf_bytes, nabla2_bytes, nabla4_bytes, apply_bytes))


def sizes(config: dict) -> tuple:
    return int(config["vertices"]), int(config["edges"]), int(config["levels"])


def kernel_s(trace, prefix: str):
    """Device seconds of the kernels whose names start with ``prefix`` (the
    trace's ``device_ops``), or None where it names none."""
    found = [s for name, s in trace["breakdown"]["device_ops"] if name.startswith(prefix)]
    return sum(found) if found else None


def kernel_share(run, prefix: str, nbytes) -> float:
    """The share of its roofline of the kernel named ``prefix...`` moving
    ``nbytes(vertices, edges, levels, itemsize)`` a step, over its device
    time a step; None where the run has no complete trace of the step or
    the kernel is not in it."""
    t = run.trace
    if run.config["program"] != "icon_diffusion_vn" or not t or not t["complete"] \
            or not run.peak_Bps:
        return None
    seconds = kernel_s(t, prefix)
    if not seconds:
        return None
    return 100.0 * nbytes(*sizes(run.config), run.itemsize) / run.peak_Bps \
        / (seconds / t["steps"])


def read(run):
    t = run.trace
    config = run.config
    if config["program"] != "icon_diffusion_vn" or not t or not t["complete"] \
            or not run.peak_Bps or t["busy_s"] <= 0:
        return None
    return 100.0 * step_bytes(*sizes(config), run.itemsize) / run.peak_Bps \
        / (t["busy_s"] / t["steps"])
