"""The radial-basis interpolation's generated kernel on the icosahedral grid
(operator 1, ``mo_intp_rbf_rbf_vec_interpol_vertex``, called twice a step,
its neighbor sums masking V2E's skip values at the pentagons): its share
of its memory roofline, in %: twice its compulsory bytes
(icon_vn_roofline.rbf_bytes) at the card's published peak, over its own
device time a step (the trace's ``device_ops`` entry of
``gt_neighbor_mo_intp_rbf_rbf_vec_interpol_vertex_...``). Read only for
the program ``icon_diffusion_vn_ico`` and from a complete trace; None where
no such kernel ran."""

import os

from perfbench.spec import load_module

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KERNEL = "gt_neighbor_mo_intp_rbf_rbf_vec_interpol_vertex_"


def read(run):
    step = load_module(ROOT, "metrics", "icon_vn_roofline")
    share = load_module(ROOT, "metrics", "icon_ico_roofline")
    return share.kernel_share(run, KERNEL, lambda *s: 2 * step.rbf_bytes(*s))
