"""The generated kernel of the radial-basis interpolation from edges to
vertices (operator 1, ``mo_intp_rbf_rbf_vec_interpol_vertex``), which the
step calls twice: its share of its memory roofline, in %: twice its
compulsory bytes (icon_vn_roofline.rbf_bytes) at the card's published
peak, over its own device time a step (the trace's ``device_ops`` entry of
``gt_neighbor_mo_intp_rbf_rbf_vec_interpol_vertex_...``). Read only from a
trace that holds every launch of the port's kernels; None where no such
kernel ran."""

import os

from perfbench.spec import load_module

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KERNEL = "gt_neighbor_mo_intp_rbf_rbf_vec_interpol_vertex_"


def read(run):
    step = load_module(ROOT, "metrics", "icon_vn_roofline")
    return step.kernel_share(run, KERNEL, lambda *s: 2 * step.rbf_bytes(*s))
