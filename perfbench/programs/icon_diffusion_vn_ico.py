"""ICON's horizontal diffusion of the normal wind ``vn`` on ICON's global
icosahedral grid: the operators, the ``@program`` and the geometry of
perfbench/programs/icon_diffusion_vn.py (loaded by ``spec.load_module``,
not copied) on ``mesh_utils.icosahedral_mesh(mesh_root, mesh_bisections)``
in place of the torus.

The grid has twelve pentagons: ``V2E``'s sixth slot holds the skip value
-1 there, so the radial-basis interpolation's neighbor sums mask it (the
``ptr_coeff`` values of a masked slot are drawn but never summed);
``E2C2V`` and ``E2ECV`` have no skip value (every edge has two cells). The
numbering is ``icosahedral_mesh``'s: cells in construction order (a quadtree below
the root triangles), vertices and edges by first appearance; not row-major.

``build(config)`` checks that the port has ``icosahedral_mesh``, lowers each
operator on R01B01 (80 cells, 42 vertices, 12 of them pentagons) on the CPU
and raises where the port declines any of them, then gives the program on
the configuration's backend; ``operands(config, inputs)`` the offset
provider and the program's keyword arguments over the harness's tensors,
``K`` innermost and contiguous.
"""

import json
import os

from perfbench.spec import load_module

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TORUS = load_module(ROOT, "programs", "icon_diffusion_vn")

OPERATORS = TORUS.OPERATORS
WRITTEN = TORUS.WRITTEN
make_program = TORUS.make_program
geometry = TORUS.geometry
Edge, Vertex, ECV, K = TORUS.Edge, TORUS.Vertex, TORUS.ECV, TORUS.K
V2EDim, E2C2VDim = TORUS.V2EDim, TORUS.E2C2VDim

#: the grid ``build`` lowers the step on: R01B01
SMALL_GRID = (1, 1)
#: each operator's call in the step: (its arguments' names, its outs' names)
CALLS = (
    (("vn", "ptr_coeff_1", "ptr_coeff_2"), ("u_vert", "v_vert")),
    (("diff_multfac_smag", "tangent_orientation", "inv_primal_edge_length",
      "inv_vert_vert_length", "u_vert", "v_vert", "primal_normal_vert_x", "primal_normal_vert_y",
      "dual_normal_vert_x", "dual_normal_vert_y", "vn", "smag_limit", "smag_offset"),
     ("kh_smag_e", "kh_smag_ec", "z_nabla2_e")),
    (("u_vert", "v_vert", "primal_normal_vert_x", "primal_normal_vert_y", "z_nabla2_e",
      "inv_vert_vert_length", "inv_primal_edge_length"), ("z_nabla4_e2",)),
    (("area_edge", "kh_smag_e", "z_nabla2_e", "z_nabla4_e2", "diff_multfac_vn", "nudgecoeff_e",
      "vn", "nudgezone_diff"), ("vn",)),
)


def mesh(config: dict) -> dict:
    """The configuration's grid (``mesh_utils.icosahedral_mesh``)."""
    from gt4py_tpu_torch.next.mesh_utils import icosahedral_mesh

    return icosahedral_mesh(int(config["mesh_root"]), int(config["mesh_bisections"]))


def operands(config: dict, inputs: dict):
    """(keyword arguments, offset provider) of a call on the harness's
    ``inputs`` (``vn`` and the written fields: (edges or vertices, levels)
    tensors, used in place)."""
    import gt4py_tpu_torch.next as gtx
    from gt4py_tpu_torch.next.embedded import Field

    vn = inputs["vn"]
    device, dtype = vn.device, vn.dtype
    tables = mesh(config)
    skip = tables["skip_values"]
    provider = {
        "V2E": gtx.as_connectivity([Vertex, V2EDim], Edge, tables["V2E"],
                                   skip_value=skip["V2E"], device=device),
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
    return kwargs, provider


def small_config(config: dict, root: int = 1, bisections: int = 1, nk: int = 3) -> dict:
    """``config`` on the grid R<root>B<bisections> at ``nk`` levels."""
    config = json.loads(json.dumps(config))
    n = root * root * 4 ** bisections
    nv, ne, nc = 10 * n + 2, 30 * n, 20 * n
    config.update(mesh_root=root, mesh_bisections=bisections, vertices=nv, edges=ne, cells=nc,
                  levels=nk)
    for role, field in config["fields"].items():
        field["shape"] = [nv if role in ("u_vert", "v_vert") else ne, nk]
    return config


def lowered(config: dict) -> list:
    """Each operator of the step lowered (``unstructured_codegen.lower``) on
    R01B01 on the CPU, in the step's order; raises
    ``unstructured_codegen.Declined`` where the port declines one."""
    import torch

    from gt4py_tpu_torch.next import unstructured_codegen as uc

    small = small_config(config, *SMALL_GRID)
    dtype = getattr(torch, config["dtype"])
    inputs = {r: torch.zeros(f["shape"], dtype=dtype) for r, f in small["fields"].items()}
    kw, provider = operands(small, inputs)
    programs = []
    for op, (names, outs) in zip(OPERATORS, CALLS):
        out = tuple(kw[n] for n in outs)
        programs.append(uc.lower(op, tuple(kw[n] for n in names), {},
                                 out if len(out) > 1 else out[0], provider))
    return programs


def build(config: dict):
    """``diffusion_vn`` on the configuration's backend. Raises where the
    port has no ``mesh_utils.icosahedral_mesh`` or no generated gather-reduce
    kernel, or declines any of the step's operators (lowered first on
    R01B01 on the CPU), so that a tree that cannot serve the step on the
    card fails in set-up."""
    from gt4py_tpu_torch.cartesian.backend import cuda_backend
    from gt4py_tpu_torch.next import mesh_utils

    if not hasattr(mesh_utils, "icosahedral_mesh"):
        raise RuntimeError("gt4py_tpu_torch has no icosahedral grid "
                           "(mesh_utils.icosahedral_mesh)")
    if "neighbor" not in cuda_backend.WRAPPERS:
        raise RuntimeError("gt4py_tpu_torch has no kernel for unstructured field operators "
                           "(cuda_backend.WRAPPERS has no 'neighbor')")
    lowered(config)
    return make_program(config["backend"])
