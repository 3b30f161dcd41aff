"""The update of ``vn`` on the icosahedral grid (operator 4,
``apply_nabla2_and_nabla4_to_vn``): its share of its memory roofline, in
%: its compulsory bytes (icon_vn_roofline.apply_bytes) at the card's
published peak, over the device's busy time a step less the three gather
kernels' (the ``device_ops`` entries of the ``icon_ico_rbf_roofline``,
``icon_ico_nabla2_roofline`` and ``icon_ico_nabla4_roofline`` kernels),
so that it reads whichever kernel serves the update. Read only for the
program ``icon_diffusion_vn_ico`` and from a complete trace; None where a
gather kernel is not in it."""

import os

from perfbench.spec import load_module

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GATHERS = ("icon_ico_rbf_roofline", "icon_ico_nabla2_roofline", "icon_ico_nabla4_roofline")


def read(run):
    step = load_module(ROOT, "metrics", "icon_vn_roofline")
    t = load_module(ROOT, "metrics", "icon_ico_roofline")._traced(run)
    if not t or t["busy_s"] <= 0:
        return None
    seconds = [step.kernel_s(t, load_module(ROOT, "metrics", g).KERNEL) for g in GATHERS]
    if any(not s for s in seconds):
        return None
    rest = (t["busy_s"] - sum(seconds)) / t["steps"]
    if rest <= 0:
        return None
    return 100.0 * step.apply_bytes(*step.sizes(run.config), run.itemsize) / run.peak_Bps / rest
