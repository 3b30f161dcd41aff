"""tests/parallel_tests/test_distributed_unstructured.py on the port:
DistributedUnstructured runs the plain field-view DSL (remap /
neighbor_sum with offset providers) on a ring of eight CPU devices with
explicit ghosts — halo slabs from the ring neighbours only, never a whole
field (asserted on ``exchange_plan``, where the reference reads the HLO).
Single-device embedded execution is the oracle."""

import numpy as np
import pytest
import torch

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.next import Dimension, DimensionKind, FieldOffset, neighbor_sum
from gt4py_tpu_torch.next.embedded import offset_provider_context
from gt4py_tpu_torch.next.mesh_utils import Renumbering, periodic_quad_mesh
from gt4py_tpu_torch.parallel.unstructured import DistributedUnstructured

V = Dimension("Vertex")
E = Dimension("Edge")
V2EDim = Dimension("V2E", kind=DimensionKind.LOCAL)
E2VDim = Dimension("E2V", kind=DimensionKind.LOCAL)
V2E = FieldOffset("V2E", source=E, target=(V, V2EDim))
E2V = FieldOffset("E2V", source=V, target=(E, E2VDim))
V2V = FieldOffset("V2V", source=V, target=(V, V2EDim))

CPU8 = [torch.device("cpu")] * 8


@gtx.field_operator
def nabla(pp, s_x, sign, vol):
    zavg = 0.5 * (pp(E2V[0]) + pp(E2V[1])) * s_x
    return neighbor_sum(zavg(V2E) * sign, axis=V2EDim) / vol


@gtx.field_operator
def ring_sum(f):
    return neighbor_sum(f(V2V), axis=V2EDim)


def edge_row_interleave(nmesh):
    """Renumbering that interleaves horizontal/vertical edges by grid row
    (periodic_quad_mesh numbers ALL horizontal edges first, which is not
    ring-partition-aligned with the vertex blocks — the advertised
    renumber-first workflow)."""
    nv = nmesh * nmesh
    i, j = np.divmod(np.arange(nv, dtype=np.int64), nmesh)
    perm = np.empty(2 * nv, dtype=np.int64)
    perm[:nv] = i * 2 * nmesh + j  # horizontal edge h(i,j)
    perm[nv:] = i * 2 * nmesh + nmesh + j  # vertical edge v(i,j)
    return Renumbering(E, perm)


def _quad_case(nmesh, rng):
    e2v_np, v2e_np, signs_np = periodic_quad_mesh(nmesh)
    nv = nmesh * nmesh
    e2v = gtx.as_connectivity([E, E2VDim], V, e2v_np, device="cpu")
    v2e = gtx.as_connectivity([V, V2EDim], E, v2e_np, device="cpu")
    pp = gtx.as_field([V], rng.random(nv).astype(np.float32), device="cpu")
    sx = gtx.as_field([E], rng.random(2 * nv).astype(np.float32), device="cpu")
    sign = gtx.as_field([V, V2EDim], signs_np.astype(np.float32), device="cpu")
    vol = gtx.as_field([V], (rng.random(nv) + 0.5).astype(np.float32), device="cpu")
    return e2v, v2e, pp, sx, sign, vol, nv


def test_fvm_nabla_plain_dsl_sharded():
    """The reference FVM-nabla operator, unchanged, on the 8-device ring
    (edge numbering ring-aligned via Renumbering; outputs come back in
    the user's numbering)."""
    rng = np.random.default_rng(0)
    e2v, v2e, pp, sx, sign, vol, nv = _quad_case(16, rng)

    with offset_provider_context({"E2V": e2v, "V2E": v2e}):
        expected = nabla.definition(pp, sx, sign, vol).ndarray.numpy()

    dist = DistributedUnstructured(
        nabla,
        offset_provider={"E2V": e2v, "V2E": v2e},
        sizes={V: nv, E: 2 * nv},
        renumberings=[edge_row_interleave(16)],
        mesh=CPU8,
    )
    got = dist(pp, sx, sign, vol)
    assert got.dims == (V,)
    np.testing.assert_allclose(got.ndarray.numpy(), expected, rtol=1e-5)


def test_unaligned_numbering_raises_with_advice():
    rng = np.random.default_rng(1)
    e2v, v2e, pp, sx, sign, vol, nv = _quad_case(16, rng)
    with pytest.raises(ValueError, match="renumber"):
        DistributedUnstructured(
            nabla,
            offset_provider={"E2V": e2v, "V2E": v2e},
            sizes={V: nv, E: 2 * nv},
            mesh=CPU8,
        )


def test_hlo_collective_permute_only():
    """Every slab a shard receives comes from a ring neighbour and is a
    thin halo, never a whole field."""
    rng = np.random.default_rng(1)
    e2v, v2e, pp, sx, sign, vol, nv = _quad_case(16, rng)
    dist = DistributedUnstructured(
        nabla,
        offset_provider={"E2V": e2v, "V2E": v2e},
        sizes={V: nv, E: 2 * nv},
        renumberings=[edge_row_interleave(16)],
        mesh=CPU8,
    )
    plan = dist.exchange_plan(pp, sx, sign, vol)
    assert plan, "halo exchange missing"
    assert {t["table"] for t in plan} == {"E2V", "V2E"}
    for t in plan:
        assert (t["src"] - t["dst"]) % 8 in (1, 7)
    # the gathers from a shard's owned block: E2V (vertices, 32 a shard)
    # twice, V2E (edges, 64 a shard) once; each slab a thin halo
    for t in plan:
        owned = nv // 8 if t["table"] == "E2V" else 2 * nv // 8
        assert t["slab"][0] < owned, "field values were gathered whole"
    received = {}
    for t in plan:
        received[t["dst"]] = received.get(t["dst"], 0) + t["slab"][0]
    assert max(received.values()) < nv


def test_uneven_sizes_pad_and_trim():
    """Element counts not divisible by the ring width: pad internally,
    trim on the way out (cartesian DistributedStencil parity)."""
    rng = np.random.default_rng(2)
    n = 44  # not divisible by 8
    ring = (np.arange(n)[:, None] + np.array([[-1, 0, 1]])) % n
    conn = gtx.as_connectivity([V, V2EDim], V, ring, device="cpu")
    x = gtx.as_field([V], rng.random(n).astype(np.float32), device="cpu")

    with offset_provider_context({"V2V": conn}):
        expected = ring_sum.definition(x).ndarray.numpy()

    dist = DistributedUnstructured(
        ring_sum, offset_provider={"V2V": conn}, sizes={V: n}, mesh=CPU8
    )
    got = dist(x)
    assert got.shape == (n,)
    np.testing.assert_allclose(got.ndarray.numpy(), expected, rtol=1e-5)


def test_skip_values_masked_end_to_end():
    rng = np.random.default_rng(3)
    n = 64
    tbl = (np.arange(n)[:, None] + np.array([[0, 1, -1]])) % n
    tbl[5, 2] = -1
    tbl[40, 0] = -1
    conn = gtx.as_connectivity([V, V2EDim], V, tbl, skip_value=-1, device="cpu")
    x = gtx.as_field([V], rng.random(n).astype(np.float32), device="cpu")

    with offset_provider_context({"V2V": conn}):
        expected = ring_sum.definition(x).ndarray.numpy()

    dist = DistributedUnstructured(
        ring_sum, offset_provider={"V2V": conn}, sizes={V: n}, mesh=CPU8
    )
    got = dist(x)
    np.testing.assert_allclose(got.ndarray.numpy(), expected, rtol=1e-5)


def test_renumbering_recovers_scrambled_mesh():
    """A scrambled numbering is NOT ring-partitionable (partition_gather
    raises with renumbering advice); passing the un-scrambling
    Renumbering makes the same mesh work, with outputs returned in the
    USER's (scrambled) numbering."""
    rng = np.random.default_rng(4)
    n = 64
    ring = (np.arange(n)[:, None] + np.array([[-1, 0, 1]])) % n
    perm = rng.permutation(n)  # perm[old] = new (scramble)
    inv = np.argsort(perm)
    scr = perm[ring][inv]  # the ring mesh under scrambled vertex ids

    conn = gtx.as_connectivity([V, V2EDim], V, scr, device="cpu")
    x_np = rng.random(n).astype(np.float32)
    x = gtx.as_field([V], x_np, device="cpu")

    with pytest.raises(ValueError, match="renumber"):
        DistributedUnstructured(
            ring_sum, offset_provider={"V2V": conn}, sizes={V: n}, mesh=CPU8
        )

    renum = Renumbering(V, inv)
    dist = DistributedUnstructured(
        ring_sum,
        offset_provider={"V2V": conn},
        sizes={V: n},
        renumberings=[renum],
        mesh=CPU8,
    )
    got = dist(x)
    np.testing.assert_allclose(
        got.ndarray.numpy(), x_np[scr].sum(axis=1), rtol=1e-5
    )
