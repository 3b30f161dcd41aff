"""The generated kernel of the Laplacian and the Smagorinsky coefficients on
the icosahedral grid (operator 2,
``calculate_nabla2_and_smag_coefficients_for_vn``): its share of its memory
roofline, in %: its compulsory bytes (icon_vn_roofline.nabla2_bytes) at the
card's published peak, over its own device time a step (the trace's
``device_ops`` entry of
``gt_neighbor_calculate_nabla2_and_smag_coefficients_for_vn_...``). Read
only for the program ``icon_diffusion_vn_ico`` and from a complete trace;
None where no such kernel ran."""

import os

from perfbench.spec import load_module

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KERNEL = "gt_neighbor_calculate_nabla2_and_smag_coefficients_for_vn_"


def read(run):
    step = load_module(ROOT, "metrics", "icon_vn_roofline")
    share = load_module(ROOT, "metrics", "icon_ico_roofline")
    return share.kernel_share(run, KERNEL, step.nabla2_bytes)
