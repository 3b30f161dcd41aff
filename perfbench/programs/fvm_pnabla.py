"""The FVM nabla as gt4py's users write it in the field view: ECMWF's
finite-volume dycore FVM (Kühnlein et al., FVM 1.0, GMD 12:651-676, 2019)
applies it on the median-dual mesh of the octahedral grid through atlas.

Copied from gt4py's ``tests/next_tests/integration_tests/feature_tests/
ffront_tests/test_fvm_nabla.py`` (``compute_zavgS``, ``compute_pnabla``,
``pnabla``) with a vertical dimension ``K`` on the vertex and output fields
(every level of a column) and the two dual-face components passed as two
fields; left unannotated, so that one definition serves float32 and float64.
Each component averages the vertex values onto each edge (``E2V``), scales
the edge value by its dual face, sums the edge values with orientation
signs over each vertex's edges (``V2E``) and divides by the dual volume.

``build(config)`` gives the operator on the configuration's backend;
``operands(config, inputs)`` the mesh (the periodic quad mesh of
``mesh_utils.periodic_quad_mesh``, row-major, standing in for atlas's
median-dual mesh), its geometry (``S_MXX``, ``S_MYY`` and ``vol`` drawn
from the configuration's geometry seed, ``sign`` the mesh's orientation),
the offset provider, and the fields over the harness's tensors: ``pp`` and
the outputs wrapped without a copy, ``K`` innermost and contiguous.
"""

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.next import Dimension, DimensionKind, FieldOffset, neighbor_sum

Vertex = Dimension("Vertex")
Edge = Dimension("Edge")
K = Dimension("K", kind=DimensionKind.VERTICAL)
V2EDim = Dimension("V2E", kind=DimensionKind.LOCAL)
E2VDim = Dimension("E2V", kind=DimensionKind.LOCAL)
V2E = FieldOffset("V2E", source=Edge, target=(Vertex, V2EDim))
E2V = FieldOffset("E2V", source=Vertex, target=(Edge, E2VDim))


@gtx.field_operator
def compute_zavgS(pp, S_M):
    zavg = 0.5 * (pp(E2V[0]) + pp(E2V[1]))
    return S_M * zavg


@gtx.field_operator
def compute_pnabla(pp, S_M, sign, vol):
    zavgS = compute_zavgS(pp, S_M)
    pnabla_M = neighbor_sum(zavgS(V2E) * sign, axis=V2EDim)
    return pnabla_M / vol


@gtx.field_operator
def pnabla(pp, S_MXX, S_MYY, sign, vol):
    return compute_pnabla(pp, S_MXX, sign, vol), compute_pnabla(pp, S_MYY, sign, vol)


def build(config: dict):
    """``pnabla`` on the configuration's backend. Raises where the port has
    no generated gather-reduce kernel to serve it on a card."""
    from gt4py_tpu_torch.cartesian.backend import cuda_backend

    if "neighbor" not in cuda_backend.WRAPPERS:
        raise RuntimeError("gt4py_tpu_torch has no kernel for unstructured field operators "
                           "(cuda_backend.WRAPPERS has no 'neighbor')")
    return pnabla.with_backend(config["backend"])


def geometry(config: dict, device, dtype):
    """(S_MXX, S_MYY, vol) drawn from the configuration's geometry seed by one
    ``torch.Generator`` on ``device``: S_MXX and S_MYY uniform in [0, 1) over
    the edges, vol uniform in [0.5, 1.5) over the vertices."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(int(config["geometry_seed"]))
    ne, nv = int(config["edges"]), int(config["columns"])
    s_mxx = torch.rand(ne, generator=gen, device=device, dtype=torch.float32)
    s_myy = torch.rand(ne, generator=gen, device=device, dtype=torch.float32)
    vol = torch.rand(nv, generator=gen, device=device, dtype=torch.float32) + 0.5
    return s_mxx.to(dtype), s_myy.to(dtype), vol.to(dtype)


def operands(config: dict, inputs: dict):
    """(arguments, out, offset provider) of a call on the harness's
    ``inputs`` (``pp``, ``pnabla_M``, ``pnabla_P``: (columns, levels)
    tensors, used in place)."""
    import numpy as np
    import torch

    from gt4py_tpu_torch.next.embedded import Field
    from gt4py_tpu_torch.next.mesh_utils import periodic_quad_mesh

    pp = inputs["pp"]
    device, dtype = pp.device, pp.dtype
    nv, nk = pp.shape
    e2v, v2e, signs = periodic_quad_mesh(int(config["mesh_n"]))
    provider = {
        "E2V": gtx.as_connectivity([Edge, E2VDim], Vertex, e2v, device=device),
        "V2E": gtx.as_connectivity([Vertex, V2EDim], Edge, v2e, device=device),
    }
    s_mxx, s_myy, vol = geometry(config, device, dtype)
    sign = torch.as_tensor(signs.astype(np.float32), device=device).to(dtype)

    def field(dims, t):
        return Field(gtx.domain({d: (0, n) for d, n in zip(dims, t.shape)}), t)

    args = (field((Vertex, K), pp), field((Edge,), s_mxx), field((Edge,), s_myy),
            field((Vertex, V2EDim), sign), field((Vertex,), vol))
    out = (field((Vertex, K), inputs["pnabla_M"]), field((Vertex, K), inputs["pnabla_P"]))
    assert out[0].ndarray.shape == (nv, nk)
    return args, out, provider
