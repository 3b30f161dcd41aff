"""ICON's vn diffusion step on the icosahedral grid (icon-diffusion-vn-ico):
its share of its memory roofline, in %: the step's compulsory bytes
(icon_vn_roofline.step_bytes at this grid's sizes) at the card's published
peak, over the device's busy time a step in the traced calls. Read only for
the program ``icon_diffusion_vn_ico`` and only from a trace that holds
every launch of the port's kernels.

``kernel_share`` is the same share for one kernel of the step, over its own
device time a step (the ``icon_ico_*_roofline`` metrics).
"""

import os

from perfbench.spec import load_module

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PROGRAM = "icon_diffusion_vn_ico"


def _traced(run):
    """The run's trace where it is this program's and complete, else None."""
    t = run.trace
    if run.config["program"] != PROGRAM or not t or not t["complete"] or not run.peak_Bps:
        return None
    return t


def kernel_share(run, prefix: str, nbytes):
    """The share of its roofline of the kernel named ``prefix...`` moving
    ``nbytes(vertices, edges, levels, itemsize)`` a step, over its device
    time a step (icon_vn_roofline.kernel_s); None where the run has no
    complete trace of the step or the kernel is not in it."""
    step = load_module(ROOT, "metrics", "icon_vn_roofline")
    t = _traced(run)
    seconds = step.kernel_s(t, prefix) if t else None
    if not seconds:
        return None
    return 100.0 * nbytes(*step.sizes(run.config), run.itemsize) / run.peak_Bps \
        / (seconds / t["steps"])


def read(run):
    step = load_module(ROOT, "metrics", "icon_vn_roofline")
    t = _traced(run)
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * step.step_bytes(*step.sizes(run.config), run.itemsize) / run.peak_Bps \
        / (t["busy_s"] / t["steps"])
