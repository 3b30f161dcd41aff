"""The FVM nabla in plain PyTorch, written from gt4py's ``test_fvm_nabla.py``
definition (perfbench/programs/fvm_pnabla.py) on the configuration's mesh.

``step`` applies it once to ``pp`` (columns, levels) and returns both
components, ``pnabla_M`` (through ``S_MXX``) and ``pnabla_P`` (through
``S_MYY``), in ``pp``'s dtype. It builds the mesh and its geometry itself
from the configuration: the periodic ``mesh_n`` x ``mesh_n`` quad mesh in
row-major numbering (horizontal edges first, each joining (i, j) and
(i + 1, j), then vertical ones, joining (i, j) and (i, j + 1), both
wrapping; a vertex's edges ordered leaving and entering horizontally, then
vertically, with signs +1, -1, +1, -1), S_MXX and S_MYY uniform in [0, 1)
over the edges and vol uniform in [0.5, 1.5) over the vertices, drawn in
that order, in float32, by one ``torch.Generator`` on ``pp``'s device from
``geometry_seed``. Operations in the definition's order.
"""

import torch


def mesh(n: int, device):
    """(e2v (2n², 2), v2e (n², 4), sign (n², 4)) of the periodic n x n mesh."""
    v = torch.arange(n * n, device=device)
    i, j = v // n, v % n

    def vid(ii, jj):
        return (ii % n) * n + (jj % n)

    e2v = torch.cat([torch.stack([v, vid(i + 1, j)], dim=1),
                     torch.stack([v, vid(i, j + 1)], dim=1)])
    v2e = torch.stack([v, vid(i - 1, j), n * n + v, n * n + vid(i, j - 1)], dim=1)
    sign = torch.tensor([1.0, -1.0, 1.0, -1.0], device=device).expand(n * n, 4)
    return e2v, v2e, sign


def geometry(config: dict, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(config["geometry_seed"]))
    ne, nv = 2 * config["mesh_n"] ** 2, config["mesh_n"] ** 2
    s_mxx = torch.rand(ne, generator=gen, device=device, dtype=torch.float32)
    s_myy = torch.rand(ne, generator=gen, device=device, dtype=torch.float32)
    vol = torch.rand(nv, generator=gen, device=device, dtype=torch.float32) + 0.5
    return s_mxx, s_myy, vol


def step(fields: dict, config: dict) -> dict:
    pp = fields["pp"]
    e2v, v2e, sign = mesh(int(config["mesh_n"]), pp.device)
    s_mxx, s_myy, vol = (g.to(pp.dtype) for g in geometry(config, pp.device))
    sign = sign.to(pp.dtype)
    zavg = 0.5 * (pp[e2v[:, 0]] + pp[e2v[:, 1]])
    out = {}
    for role, s_m in (("pnabla_M", s_mxx), ("pnabla_P", s_myy)):
        zavgs = s_m[:, None] * zavg
        out[role] = (zavgs[v2e] * sign[:, :, None]).sum(dim=1) / vol[:, None]
        del zavgs
    return out
