"""The update of ``vn`` (operator 4, ``apply_nabla2_and_nabla4_to_vn``):
its share of its memory roofline, in %: its compulsory bytes
(icon_vn_roofline.apply_bytes) at the card's published peak, over the
device's busy time a step less the three gather kernels' (the trace's
``device_ops`` entries ``gt_neighbor_<operator>_...`` of operators 1 to 3),
so that it reads whichever kernel serves the update. Read only from a trace
that holds every launch of the port's kernels; None where a gather kernel
is not in it."""

import os

from perfbench.spec import load_module

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GATHERS = ("icon_rbf_roofline", "icon_nabla2_roofline", "icon_nabla4_roofline")


def read(run):
    t = run.trace
    config = run.config
    if config["program"] != "icon_diffusion_vn" or not t or not t["complete"] \
            or not run.peak_Bps or t["busy_s"] <= 0:
        return None
    gathers = [load_module(ROOT, "metrics", name) for name in GATHERS]
    step = load_module(ROOT, "metrics", "icon_vn_roofline")
    seconds = [step.kernel_s(t, g.KERNEL) for g in gathers]
    if any(not s for s in seconds):
        return None
    rest = (t["busy_s"] - sum(seconds)) / t["steps"]
    if rest <= 0:
        return None
    return 100.0 * step.apply_bytes(*step.sizes(config), run.itemsize) / run.peak_Bps / rest
