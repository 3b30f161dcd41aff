"""ICON's horizontal diffusion of the normal wind ``vn`` as ICON4Py writes it
in the field view: ``mo_nh_diffusion.f90``, ``diffusion_type`` 5
(Smagorinsky diffusion plus fourth-order background diffusion), its ``vn``
branch, in ICON4Py's diffusion stencils ``mo_intp_rbf_rbf_vec_interpol_vertex``,
``calculate_nabla2_and_smag_coefficients_for_vn``, ``calculate_nabla4`` and
``apply_nabla2_and_nabla4_to_vn``; left unannotated, as the FVM nabla is, so
that one definition serves every dtype.

Dimensions: ``Edge``, ``Vertex`` and ``ECV`` (an edge's four
edge-to-cell-vertex slots) horizontal, ``K`` vertical, ``V2EDim`` and
``E2C2VDim`` local. Offsets, written source -> target: ``V2E`` (Edge ->
Vertex, six edges a vertex), ``E2C2V`` (Vertex -> Edge: the edge's two ends,
then the vertices opposite it in its two cells) and ``E2ECV`` (ECV -> Edge,
the table ``4e + i``). Each operator's operations are written in the order
ICON4Py's stencil computes them, so that a plain reference in that order
matches it to the bit.

``diffusion_vn`` is one call of the step: five operator calls, each with
``out=``, ``vn`` updated in place by the last. ``build(config)`` lowers
each operator on a small torus on the CPU first and raises where the port
declines any of them, then gives the program on the configuration's
backend; ``operands(config, inputs)`` the mesh (``mesh_utils.
periodic_triangle_mesh``), the geometry and vertical profiles drawn from the
configuration's ``geometry_seed`` (:func:`geometry`), the offset provider,
and the program's keyword arguments over the harness's tensors, ``K``
innermost and contiguous.
"""

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.next import (
    Dimension,
    DimensionKind,
    FieldOffset,
    maximum,
    minimum,
    neighbor_sum,
    sqrt,
)

Edge = Dimension("Edge")
Vertex = Dimension("Vertex")
ECV = Dimension("ECV")
K = Dimension("K", kind=DimensionKind.VERTICAL)
V2EDim = Dimension("V2E", kind=DimensionKind.LOCAL)
E2C2VDim = Dimension("E2C2V", kind=DimensionKind.LOCAL)
V2E = FieldOffset("V2E", source=Edge, target=(Vertex, V2EDim))
E2C2V = FieldOffset("E2C2V", source=Vertex, target=(Edge, E2C2VDim))
E2ECV = FieldOffset("E2ECV", source=ECV, target=(Edge, E2C2VDim))

#: the program's fields that the step writes, in the order of the calls
WRITTEN = ("u_vert", "v_vert", "kh_smag_e", "kh_smag_ec", "z_nabla2_e", "z_nabla4_e2", "vn")


@gtx.field_operator
def mo_intp_rbf_rbf_vec_interpol_vertex(p_e_in, ptr_coeff_1, ptr_coeff_2):
    """The vertex wind from the six edges' normal wind (radial basis
    functions)."""
    p_u_out = neighbor_sum(ptr_coeff_1 * p_e_in(V2E), axis=V2EDim)
    p_v_out = neighbor_sum(ptr_coeff_2 * p_e_in(V2E), axis=V2EDim)
    return p_u_out, p_v_out


@gtx.field_operator
def calculate_nabla2_and_smag_coefficients_for_vn(
    diff_multfac_smag, tangent_orientation, inv_primal_edge_length, inv_vert_vert_length,
    u_vert, v_vert, primal_normal_vert_x, primal_normal_vert_y, dual_normal_vert_x,
    dual_normal_vert_y, vn, smag_limit, smag_offset,
):
    """The Laplacian of ``vn`` and the Smagorinsky coefficient on each edge,
    from the vertex wind at its ends (0, 1) and opposite vertices (2, 3)."""
    p0 = u_vert(E2C2V[0]) * primal_normal_vert_x(E2ECV[0]) \
        + v_vert(E2C2V[0]) * primal_normal_vert_y(E2ECV[0])
    p1 = u_vert(E2C2V[1]) * primal_normal_vert_x(E2ECV[1]) \
        + v_vert(E2C2V[1]) * primal_normal_vert_y(E2ECV[1])
    p2 = u_vert(E2C2V[2]) * primal_normal_vert_x(E2ECV[2]) \
        + v_vert(E2C2V[2]) * primal_normal_vert_y(E2ECV[2])
    p3 = u_vert(E2C2V[3]) * primal_normal_vert_x(E2ECV[3]) \
        + v_vert(E2C2V[3]) * primal_normal_vert_y(E2ECV[3])
    d0 = u_vert(E2C2V[0]) * dual_normal_vert_x(E2ECV[0]) \
        + v_vert(E2C2V[0]) * dual_normal_vert_y(E2ECV[0])
    d1 = u_vert(E2C2V[1]) * dual_normal_vert_x(E2ECV[1]) \
        + v_vert(E2C2V[1]) * dual_normal_vert_y(E2ECV[1])
    d2 = u_vert(E2C2V[2]) * dual_normal_vert_x(E2ECV[2]) \
        + v_vert(E2C2V[2]) * dual_normal_vert_y(E2ECV[2])
    d3 = u_vert(E2C2V[3]) * dual_normal_vert_x(E2ECV[3]) \
        + v_vert(E2C2V[3]) * dual_normal_vert_y(E2ECV[3])
    dvt_tang = -d0 + d1
    dvt_norm = -d2 + d3
    kh_smag_1 = (tangent_orientation * inv_primal_edge_length) * (-p0 + p1) \
        + inv_vert_vert_length * dvt_norm
    kh_smag_1 = kh_smag_1 * kh_smag_1
    kh_smag_2 = inv_vert_vert_length * (-p2 + p3) \
        - (tangent_orientation * inv_primal_edge_length) * dvt_tang
    kh_smag_2 = kh_smag_2 * kh_smag_2
    kh_smag_ec = diff_multfac_smag * sqrt(kh_smag_2 + kh_smag_1)
    z_nabla2_e = ((p0 + p1) - 2.0 * vn) * (inv_primal_edge_length * inv_primal_edge_length)
    z_nabla2_e = z_nabla2_e + ((p2 + p3) - 2.0 * vn) * (
        inv_vert_vert_length * inv_vert_vert_length)
    z_nabla2_e = 4.0 * z_nabla2_e
    kh_smag_e = minimum(maximum(0.0, kh_smag_ec - smag_offset), smag_limit)
    return kh_smag_e, kh_smag_ec, z_nabla2_e


@gtx.field_operator
def calculate_nabla4(u_vert, v_vert, primal_normal_vert_x, primal_normal_vert_y, z_nabla2_e,
                     inv_vert_vert_length, inv_primal_edge_length):
    """The Laplacian of the Laplacian, from the vertex wind of ``z_nabla2_e``."""
    q0 = u_vert(E2C2V[0]) * primal_normal_vert_x(E2ECV[0]) \
        + v_vert(E2C2V[0]) * primal_normal_vert_y(E2ECV[0])
    q1 = u_vert(E2C2V[1]) * primal_normal_vert_x(E2ECV[1]) \
        + v_vert(E2C2V[1]) * primal_normal_vert_y(E2ECV[1])
    q2 = u_vert(E2C2V[2]) * primal_normal_vert_x(E2ECV[2]) \
        + v_vert(E2C2V[2]) * primal_normal_vert_y(E2ECV[2])
    q3 = u_vert(E2C2V[3]) * primal_normal_vert_x(E2ECV[3]) \
        + v_vert(E2C2V[3]) * primal_normal_vert_y(E2ECV[3])
    nabv_tang = q0 + q1
    nabv_norm = q2 + q3
    z_nabla4_e2 = 4.0 * ((nabv_norm - 2.0 * z_nabla2_e) * (
        inv_vert_vert_length * inv_vert_vert_length) + (nabv_tang - 2.0 * z_nabla2_e) * (
        inv_primal_edge_length * inv_primal_edge_length))
    return z_nabla4_e2


@gtx.field_operator
def apply_nabla2_and_nabla4_to_vn(area_edge, kh_smag_e, z_nabla2_e, z_nabla4_e2,
                                  diff_multfac_vn, nudgecoeff_e, vn, nudgezone_diff):
    """``vn`` plus the Smagorinsky (or nudging-zone) and fourth-order
    diffusion."""
    vn = vn + area_edge * (maximum(nudgezone_diff * nudgecoeff_e, kh_smag_e) * z_nabla2_e
                           - diff_multfac_vn * z_nabla4_e2 * area_edge)
    return vn


OPERATORS = (mo_intp_rbf_rbf_vec_interpol_vertex, calculate_nabla2_and_smag_coefficients_for_vn,
             calculate_nabla4, apply_nabla2_and_nabla4_to_vn)


def make_program(backend):
    """The step, ``diffusion_vn``, with its operators on ``backend``."""
    rbf = mo_intp_rbf_rbf_vec_interpol_vertex.with_backend(backend)
    nabla2 = calculate_nabla2_and_smag_coefficients_for_vn.with_backend(backend)
    nabla4 = calculate_nabla4.with_backend(backend)
    apply = apply_nabla2_and_nabla4_to_vn.with_backend(backend)

    @gtx.program(backend=backend)
    def diffusion_vn(
        vn, u_vert, v_vert, kh_smag_e, kh_smag_ec, z_nabla2_e, z_nabla4_e2, ptr_coeff_1,
        ptr_coeff_2, diff_multfac_smag, tangent_orientation, inv_primal_edge_length,
        inv_vert_vert_length, primal_normal_vert_x, primal_normal_vert_y, dual_normal_vert_x,
        dual_normal_vert_y, smag_limit, smag_offset, area_edge, nudgecoeff_e, diff_multfac_vn,
        nudgezone_diff,
    ):
        rbf(vn, ptr_coeff_1, ptr_coeff_2, out=(u_vert, v_vert))
        nabla2(diff_multfac_smag, tangent_orientation, inv_primal_edge_length,
               inv_vert_vert_length, u_vert, v_vert, primal_normal_vert_x, primal_normal_vert_y,
               dual_normal_vert_x, dual_normal_vert_y, vn, smag_limit, smag_offset,
               out=(kh_smag_e, kh_smag_ec, z_nabla2_e))
        rbf(z_nabla2_e, ptr_coeff_1, ptr_coeff_2, out=(u_vert, v_vert))
        nabla4(u_vert, v_vert, primal_normal_vert_x, primal_normal_vert_y, z_nabla2_e,
               inv_vert_vert_length, inv_primal_edge_length, out=z_nabla4_e2)
        apply(area_edge, kh_smag_e, z_nabla2_e, z_nabla4_e2, diff_multfac_vn, nudgecoeff_e, vn,
              nudgezone_diff, out=vn)

    return diffusion_vn


def geometry(config: dict, device, dtype) -> dict:
    """The mesh's geometry and the vertical profiles, drawn from the
    configuration's ``geometry_seed`` by one ``torch.Generator`` on
    ``device``, in float64, in the order of ``config["geometry"]``, then
    cast to ``dtype``: each entry of ``geometry`` is ``[low, high)``
    uniform over its dimension's elements (``"sign"``: -1 or +1, each with
    probability one half); each entry of ``profiles`` a value over ``K``
    from its ``bottom`` (level 0) to its ``top`` (the last level), linear
    in the level; the ``scalars`` as given."""
    import torch

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
    out = {name: t.to(dtype) for name, t in out.items()}
    out.update({name: float(v) for name, v in config["scalars"].items()})
    return out


def operands(config: dict, inputs: dict):
    """(keyword arguments, offset provider) of a call on the harness's
    ``inputs`` (``vn`` and the written fields: (edges or vertices, levels)
    tensors, used in place)."""
    import torch

    from gt4py_tpu_torch.next.embedded import Field
    from gt4py_tpu_torch.next.mesh_utils import periodic_triangle_mesh

    vn = inputs["vn"]
    device, dtype = vn.device, vn.dtype
    tables = periodic_triangle_mesh(int(config["mesh_nx"]), int(config["mesh_ny"]))
    provider = {
        "V2E": gtx.as_connectivity([Vertex, V2EDim], Edge, tables["V2E"], device=device),
        "E2C2V": gtx.as_connectivity([Edge, E2C2VDim], Vertex, tables["E2C2V"], device=device),
        "E2ECV": gtx.as_connectivity([Edge, E2C2VDim], ECV, tables["E2ECV"], device=device),
    }

    def field(dims, t):
        return Field(gtx.domain({d: (0, n) for d, n in zip(dims, t.shape)}), t)

    kwargs = {}
    for role in ("vn", "kh_smag_e", "kh_smag_ec", "z_nabla2_e", "z_nabla4_e2"):
        kwargs[role] = field((Edge, K), inputs[role])
    for role in ("u_vert", "v_vert"):
        kwargs[role] = field((Vertex, K), inputs[role])
    for name, value in geometry(config, device, dtype).items():
        if isinstance(value, float):
            kwargs[name] = value
        elif name in config["profiles"]:
            kwargs[name] = field((K,), value)
        else:
            g = config["geometry"][name]
            dims = ({"Edge": Edge, "Vertex": Vertex, "ECV": ECV}[g["over"]],) + (
                (V2EDim,) if g.get("local") == "V2E" else ())
            kwargs[name] = field(dims, value)
    assert isinstance(kwargs["vn"].ndarray, torch.Tensor)
    return kwargs, provider


def small_config(config: dict, nx: int = 6, ny: int = 4, nk: int = 3) -> dict:
    """``config`` on an ``nx`` x ``ny`` torus of ``nk`` levels."""
    import json

    config = json.loads(json.dumps(config))
    nv = nx * ny
    config.update(mesh_nx=nx, mesh_ny=ny, vertices=nv, edges=3 * nv, cells=2 * nv, levels=nk)
    for role, field in config["fields"].items():
        field["shape"] = [nv if role in ("u_vert", "v_vert") else 3 * nv, nk]
    return config


def lowered(config: dict) -> list:
    """Each operator of the step lowered (``unstructured_codegen.lower``) on
    a small torus of the configuration on the CPU, in the step's order;
    raises ``unstructured_codegen.Declined`` where the port declines one."""
    import torch

    from gt4py_tpu_torch.next import unstructured_codegen as uc

    small = small_config(config)
    dtype = getattr(torch, config["dtype"])
    inputs = {r: torch.zeros(f["shape"], dtype=dtype) for r, f in small["fields"].items()}
    kw, provider = operands(small, inputs)

    def pick(*names):
        return tuple(kw[n] for n in names)

    calls = [
        (OPERATORS[0], pick("vn", "ptr_coeff_1", "ptr_coeff_2"), (kw["u_vert"], kw["v_vert"])),
        (OPERATORS[1], pick("diff_multfac_smag", "tangent_orientation", "inv_primal_edge_length",
                            "inv_vert_vert_length", "u_vert", "v_vert", "primal_normal_vert_x",
                            "primal_normal_vert_y", "dual_normal_vert_x", "dual_normal_vert_y",
                            "vn", "smag_limit", "smag_offset"),
         (kw["kh_smag_e"], kw["kh_smag_ec"], kw["z_nabla2_e"])),
        (OPERATORS[2], pick("u_vert", "v_vert", "primal_normal_vert_x", "primal_normal_vert_y",
                            "z_nabla2_e", "inv_vert_vert_length", "inv_primal_edge_length"),
         kw["z_nabla4_e2"]),
        (OPERATORS[3], pick("area_edge", "kh_smag_e", "z_nabla2_e", "z_nabla4_e2",
                            "diff_multfac_vn", "nudgecoeff_e", "vn", "nudgezone_diff"), kw["vn"]),
    ]
    return [uc.lower(op, args, {}, out, provider) for op, args, out in calls]


def build(config: dict):
    """``diffusion_vn`` on the configuration's backend. Raises where the
    port has no generated gather-reduce kernel, or declines any of the
    step's operators (lowered first on a small torus on the CPU), so that a
    tree that cannot serve the step on the card fails in set-up."""
    from gt4py_tpu_torch.cartesian.backend import cuda_backend

    if "neighbor" not in cuda_backend.WRAPPERS:
        raise RuntimeError("gt4py_tpu_torch has no kernel for unstructured field operators "
                           "(cuda_backend.WRAPPERS has no 'neighbor')")
    lowered(config)
    return make_program(config["backend"])
