"""ICON's Smagorinsky diffusion of the normal wind in plain PyTorch, written
from the operators of perfbench/programs/icon_diffusion_vn.py (ICON4Py's
diffusion stencils, ``mo_nh_diffusion.f90``'s ``vn`` branch) on the
configuration's mesh.

``step`` applies the five calls of one step to ``vn`` (edges, levels) and
returns every field they write, in ``vn``'s dtype: ``u_vert`` and ``v_vert``
(the second interpolation's), ``kh_smag_e``, ``kh_smag_ec``, ``z_nabla2_e``,
``z_nabla4_e2`` and the new ``vn``. It builds the mesh and its geometry
itself from the configuration:

- the planar torus of ``mesh_nx`` x ``mesh_ny`` vertices in row-major
  numbering: vertex ``(r, c)`` is ``r * nx + c``; it owns the edges
  ``3v + d`` to ``(r, c + 1)``, ``(r + 1, c)`` and ``(r + 1, c - 1)``;
  ``V2E`` lists its own three and then those of ``(r, c - 1)``,
  ``(r - 1, c)`` and ``(r - 1, c + 1)`` that reach it; ``E2C2V`` an edge's
  two ends, then the vertex opposite it in the up or down triangle its
  ``E2C`` lists first, then in the other; ``E2ECV`` is ``4e + i``;
- the geometry and vertical profiles drawn from ``geometry_seed`` by one
  ``torch.Generator`` on ``vn``'s device, in float64, in the order of the
  configuration's ``geometry``, ``[low, high)`` uniform (a ``sign``: -1 where
  the draw is below one half, else +1), the profiles linear in the level,
  then cast to ``vn``'s dtype.

The operations are in the program's order, each neighbor sum a sequence of
additions from the first neighbor on. So that the reference fits on the
card beside the fields the harness holds (ten copies of the seven written
fields), the edges go in blocks (``EDGE_BLOCK``): the gathered rows of one
block are what it holds at once; and each written role but ``vn`` goes
into the tensor ``fields`` holds for it (its contents are never read: the
step overwrites them), ``vn``'s new value into a new one.
"""

import torch

#: edges a block of the edge operators
EDGE_BLOCK = 1 << 18

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def mesh(nx: int, ny: int, device) -> dict:
    """``V2E`` (nx ny, 6) and ``E2C2V`` (3 nx ny, 4) of the torus."""
    v = torch.arange(nx * ny, device=device)
    r, c = v // nx, v % nx

    def vid(rr, cc):
        return (rr % ny) * nx + (cc % nx)

    v2e = torch.stack([3 * v, 3 * v + 1, 3 * v + 2, 3 * vid(r, c - 1),
                       3 * vid(r - 1, c) + 1, 3 * vid(r - 1, c + 1) + 2], dim=1)
    e2c2v = torch.empty((3 * nx * ny, 4), dtype=torch.int64, device=device)
    ends = (vid(r, c + 1), vid(r + 1, c), vid(r + 1, c - 1))
    opposite = ((vid(r + 1, c), vid(r - 1, c + 1)), (vid(r, c + 1), vid(r + 1, c - 1)),
                (vid(r + 1, c), vid(r, c - 1)))
    for d in range(3):
        e2c2v[d::3, 0] = v
        e2c2v[d::3, 1] = ends[d]
        e2c2v[d::3, 2] = opposite[d][0]
        e2c2v[d::3, 3] = opposite[d][1]
    return {"V2E": v2e, "E2C2V": e2c2v}


def geometry(config: dict, device, dtype) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(config["geometry_seed"]))
    sizes = {"Edge": int(config["edges"]), "Vertex": int(config["vertices"]),
             "ECV": 4 * int(config["edges"])}
    out = {}
    for name, g in config["geometry"].items():
        shape = (sizes[g["over"]],) + ((6,) if g.get("local") == "V2E" else ())
        u = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
        if g["draw"] == "sign":
            out[name] = torch.where(u < 0.5, -1.0, 1.0).to(torch.float64)
        else:
            out[name] = g["low"] + (g["high"] - g["low"]) * u
    nk = int(config["levels"])
    level = torch.arange(nk, device=device, dtype=torch.float64) / max(nk - 1, 1)
    for name, p in config["profiles"].items():
        out[name] = p["bottom"] + (p["top"] - p["bottom"]) * level
    return {name: t.to(dtype) for name, t in out.items()}


def rbf(p_e_in, v2e, c1, c2, u, w):
    """Operator 1: the vertex wind from the edges' values, into ``u`` and
    ``w``."""
    u.copy_(c1[:, 0, None] * p_e_in[v2e[:, 0]])
    w.copy_(c2[:, 0, None] * p_e_in[v2e[:, 0]])
    for i in range(1, 6):
        u += c1[:, i, None] * p_e_in[v2e[:, i]]
        w += c2[:, i, None] * p_e_in[v2e[:, i]]


def normal(u, w, e2c2v, e2ecv_x, e2ecv_y, i):
    """``u(E2C2V[i]) * x(E2ECV[i]) + w(E2C2V[i]) * y(E2ECV[i])`` on a block."""
    return u[e2c2v[:, i]] * e2ecv_x[:, i, None] + w[e2c2v[:, i]] * e2ecv_y[:, i, None]


def nabla2(g, s, u, w, vn, e2c2v):
    """Operator 2 on a block of edges: (kh_smag_e, kh_smag_ec, z_nabla2_e)."""
    p = [normal(u, w, e2c2v, g["primal_normal_vert_x"], g["primal_normal_vert_y"], i)
         for i in range(4)]
    d = [normal(u, w, e2c2v, g["dual_normal_vert_x"], g["dual_normal_vert_y"], i)
         for i in range(4)]
    tang, ipel, ivvl = (g[n][:, None] for n in ("tangent_orientation", "inv_primal_edge_length",
                                               "inv_vert_vert_length"))
    dvt_tang = -d[0] + d[1]
    dvt_norm = -d[2] + d[3]
    kh_smag_1 = (tang * ipel) * (-p[0] + p[1]) + ivvl * dvt_norm
    kh_smag_1 = kh_smag_1 * kh_smag_1
    kh_smag_2 = ivvl * (-p[2] + p[3]) - (tang * ipel) * dvt_tang
    kh_smag_2 = kh_smag_2 * kh_smag_2
    kh_smag_ec = g["diff_multfac_smag"][None, :] * torch.sqrt(kh_smag_2 + kh_smag_1)
    z_nabla2_e = ((p[0] + p[1]) - 2.0 * vn) * (ipel * ipel)
    z_nabla2_e = z_nabla2_e + ((p[2] + p[3]) - 2.0 * vn) * (ivvl * ivvl)
    z_nabla2_e = 4.0 * z_nabla2_e
    zero = torch.zeros((), dtype=vn.dtype, device=vn.device)
    kh_smag_e = torch.minimum(torch.maximum(zero, kh_smag_ec - s["smag_offset"]),
                              g["smag_limit"][None, :])
    return kh_smag_e, kh_smag_ec, z_nabla2_e


def nabla4(g, u, w, z_nabla2_e, e2c2v):
    """Operator 3 on a block of edges: z_nabla4_e2."""
    q = [normal(u, w, e2c2v, g["primal_normal_vert_x"], g["primal_normal_vert_y"], i)
         for i in range(4)]
    ipel, ivvl = g["inv_primal_edge_length"][:, None], g["inv_vert_vert_length"][:, None]
    nabv_tang = q[0] + q[1]
    nabv_norm = q[2] + q[3]
    return 4.0 * ((nabv_norm - 2.0 * z_nabla2_e) * (ivvl * ivvl)
                  + (nabv_tang - 2.0 * z_nabla2_e) * (ipel * ipel))


def apply(g, s, kh_smag_e, z_nabla2_e, z_nabla4_e2, vn):
    """Operator 4 on a block of edges: the new vn."""
    area = g["area_edge"][:, None]
    nudge = s["nudgezone_diff"] * g["nudgecoeff_e"][:, None]
    return vn + area * (torch.maximum(nudge, kh_smag_e) * z_nabla2_e
                        - g["diff_multfac_vn"][None, :] * z_nabla4_e2 * area)


def _edge_geometry(config: dict, g: dict, lo: int, hi: int) -> dict:
    """The geometry of edges ``lo:hi``: the edge arrays sliced, the ECV
    arrays as (edges, 4), the profiles whole."""
    out = {name: g[name] for name in config["profiles"]}
    for name, spec in config["geometry"].items():
        if spec["over"] == "Edge":
            out[name] = g[name][lo:hi]
        elif spec["over"] == "ECV":
            out[name] = g[name].view(-1, 4)[lo:hi]
    return out


def _written(fields: dict, role: str, shape, like) -> torch.Tensor:
    """Where ``step`` writes ``role``: the tensor ``fields`` holds for it
    where it has that shape and ``like``'s dtype and device (the step
    never reads a role it writes, but ``vn``), else a new one; so the
    reference needs little beyond the fields the harness holds."""
    t = fields.get(role)
    if isinstance(t, torch.Tensor) and tuple(t.shape) == tuple(shape) \
            and t.dtype == like.dtype and t.device == like.device:
        return t
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def step(fields: dict, config: dict) -> dict:
    vn = fields["vn"]
    device, dtype = vn.device, vn.dtype
    ne, nk = vn.shape
    nv = int(config["vertices"])
    tables = mesh(int(config["mesh_nx"]), int(config["mesh_ny"]), device)
    v2e, e2c2v = tables["V2E"], tables["E2C2V"]
    g = geometry(config, device, dtype)
    s = {name: float(v) for name, v in config["scalars"].items()}
    c1, c2 = g["ptr_coeff_1"], g["ptr_coeff_2"]
    blocks = [(lo, min(lo + EDGE_BLOCK, ne)) for lo in range(0, ne, EDGE_BLOCK)]
    out = {role: _written(fields, role, (nv, nk), vn) for role in ("u_vert", "v_vert")}
    for role in ("kh_smag_e", "kh_smag_ec", "z_nabla2_e", "z_nabla4_e2"):
        out[role] = _written(fields, role, (ne, nk), vn)

    rbf(vn, v2e, c1, c2, out["u_vert"], out["v_vert"])
    for lo, hi in blocks:
        out["kh_smag_e"][lo:hi], out["kh_smag_ec"][lo:hi], out["z_nabla2_e"][lo:hi] = nabla2(
            _edge_geometry(config, g, lo, hi), s, out["u_vert"], out["v_vert"], vn[lo:hi],
            e2c2v[lo:hi])
    rbf(out["z_nabla2_e"], v2e, c1, c2, out["u_vert"], out["v_vert"])
    for lo, hi in blocks:
        out["z_nabla4_e2"][lo:hi] = nabla4(_edge_geometry(config, g, lo, hi), out["u_vert"],
                                           out["v_vert"], out["z_nabla2_e"][lo:hi], e2c2v[lo:hi])
    out["vn"] = torch.empty_like(vn)
    for lo, hi in blocks:
        out["vn"][lo:hi] = apply(_edge_geometry(config, g, lo, hi), s, out["kh_smag_e"][lo:hi],
                                 out["z_nabla2_e"][lo:hi], out["z_nabla4_e2"][lo:hi], vn[lo:hi])
    return out
