"""tests/next_tests/test_toy_connectivity.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

Toy-connectivity integration tests (reference
tests/next_tests/toy_connectivity.py + test_with_toy_connectivity.py:
a small hand-made mesh exercising remap compositions, multi-hop
gather chains, and reductions with skip values)."""

import numpy as np
import pytest

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.next import (
    Dimension,
    DimensionKind,
    FieldOffset,
    max_over,
    neighbor_sum,
)

V = Dimension("V")
E = Dimension("E")
C = Dimension("C")
V2EDim = Dimension("V2E", kind=DimensionKind.LOCAL)
E2VDim = Dimension("E2V", kind=DimensionKind.LOCAL)
C2EDim = Dimension("C2E", kind=DimensionKind.LOCAL)

E2V = FieldOffset("E2V", source=V, target=(E, E2VDim))
V2E = FieldOffset("V2E", source=E, target=(V, V2EDim))
C2E = FieldOffset("C2E", source=E, target=(C, C2EDim))

# A 2x2 periodic quad patch: 4 vertices in a ring, 4 edges, 1 cell-ish
# square plus a wrap cell. Small enough to hand-verify.
E2V_TABLE = np.array([[0, 1], [1, 2], [2, 3], [3, 0]])
V2E_TABLE = np.array([[0, 3], [0, 1], [1, 2], [2, 3]])
C2E_TABLE = np.array([[0, 1, 2, 3], [0, 2, -1, -1]])  # second cell: skips

PP = np.array([1.0, 2.0, 4.0, 8.0])
EDGE_W = np.array([1.0, 10.0, 100.0, 1000.0])


@pytest.fixture
def prov():
    return {
        "E2V": gtx.as_connectivity([E, E2VDim], V, E2V_TABLE, device="cpu"),
        "V2E": gtx.as_connectivity([V, V2EDim], E, V2E_TABLE, device="cpu"),
        "C2E": gtx.as_connectivity([C, C2EDim], E, C2E_TABLE, skip_value=-1, device="cpu"),
    }


def test_vertex_to_edge_to_vertex_composition(prov):
    @gtx.field_operator
    def vsum_of_eavg(pp):
        edge_avg = 0.5 * (pp(E2V[0]) + pp(E2V[1]))
        return neighbor_sum(edge_avg(V2E), axis=V2EDim)

    out = gtx.zeros({V: 4}, device="cpu")
    vsum_of_eavg(gtx.as_field([V], PP, device="cpu"), out=out, offset_provider=prov)
    ea = 0.5 * (PP[E2V_TABLE[:, 0]] + PP[E2V_TABLE[:, 1]])
    np.testing.assert_allclose(out.asnumpy(), ea[V2E_TABLE].sum(axis=1))


def test_three_hop_chain(prov):
    """v -> e -> v -> e: values survive two remap compositions."""

    @gtx.field_operator
    def chain(pp):
        on_e = pp(E2V[0]) - pp(E2V[1])
        back_on_v = neighbor_sum(on_e(V2E), axis=V2EDim)
        return back_on_v(E2V[0])

    out = gtx.zeros({E: 4}, device="cpu")
    chain(gtx.as_field([V], PP, device="cpu"), out=out, offset_provider=prov)
    on_e = PP[E2V_TABLE[:, 0]] - PP[E2V_TABLE[:, 1]]
    on_v = on_e[V2E_TABLE].sum(axis=1)
    np.testing.assert_allclose(out.asnumpy(), on_v[E2V_TABLE[:, 0]])


def test_cell_reduction_with_skip_values(prov):
    @gtx.field_operator
    def cell_sum(w):
        return neighbor_sum(w(C2E), axis=C2EDim)

    out = gtx.zeros({C: 2}, device="cpu")
    cell_sum(gtx.as_field([E], EDGE_W, device="cpu"), out=out, offset_provider=prov)
    expected = np.array([EDGE_W.sum(), EDGE_W[0] + EDGE_W[2]])
    np.testing.assert_allclose(out.asnumpy(), expected)


def test_cell_max_with_skip_values(prov):
    @gtx.field_operator
    def cell_max(w):
        return max_over(w(C2E), axis=C2EDim)

    out = gtx.zeros({C: 2}, device="cpu")
    cell_max(gtx.as_field([E], EDGE_W, device="cpu"), out=out, offset_provider=prov)
    np.testing.assert_allclose(out.asnumpy(), [1000.0, 100.0])


def test_weighted_reduction_mixes_local_fields(prov):
    """Sparse (local-dim) field multiplied into a gathered field before
    reduction — the FVM sign-weights pattern."""
    signs = gtx.as_field([V, V2EDim], np.array([[1.0, -1], [1, -1], [1, -1], [1, -1]]), device="cpu")

    @gtx.field_operator
    def signed(w, s):
        return neighbor_sum(w(V2E) * s, axis=V2EDim)

    out = gtx.zeros({V: 4}, device="cpu")
    signed(gtx.as_field([E], EDGE_W, device="cpu"), signs, out=out, offset_provider=prov)
    expected = (EDGE_W[V2E_TABLE] * np.array([[1.0, -1]] * 4)).sum(axis=1)
    np.testing.assert_allclose(out.asnumpy(), expected)


def test_numpy_oracle_matches_torch_on_composition(prov):
    @gtx.field_operator
    def vsum_of_eavg(pp):
        edge_avg = 0.5 * (pp(E2V[0]) + pp(E2V[1]))
        return neighbor_sum(edge_avg(V2E), axis=V2EDim)

    out_j = gtx.zeros({V: 4}, device="cpu")
    out_n = gtx.zeros({V: 4}, device="cpu")
    vsum_of_eavg(gtx.as_field([V], PP, device="cpu"), out=out_j, offset_provider=prov)
    vsum_of_eavg.with_backend("numpy")(
        gtx.as_field([V], PP, device="cpu"), out=out_n, offset_provider=prov
    )
    np.testing.assert_allclose(out_j.asnumpy(), out_n.asnumpy())


def test_external_local_field(prov):
    """A field WITH a local dimension as a direct operator input
    (reference test_external_local_field.py:24): multiply by a shifted
    field and reduce over the local dim."""
    import gt4py_tpu_torch.next as gtx

    @gtx.field_operator
    def testee(inp, ones):
        return neighbor_sum(inp * ones(V2E), axis=V2EDim)

    inp = gtx.as_field([V, V2EDim], V2E_TABLE.astype(np.int32), device="cpu")
    ones = gtx.as_field([E], np.ones(4, dtype=np.int32), device="cpu")
    out = gtx.zeros({V: 4}, dtype=np.int32, device="cpu")
    testee(inp, ones, out=out, offset_provider=prov)
    np.testing.assert_array_equal(out.asnumpy(), V2E_TABLE.sum(axis=1))


def test_index_external_local_field(prov):
    """Indexing a local dimension with NamedIndex literals
    (reference test_external_local_field.py:49: inp[V2EDim(0)] + ...)."""
    import gt4py_tpu_torch.next as gtx

    @gtx.field_operator
    def testee(inp):
        return inp[V2EDim(0)] + inp[V2EDim(1)]

    inp = gtx.as_field([V, V2EDim], V2E_TABLE.astype(np.int32), device="cpu")
    out = gtx.zeros({V: 4}, dtype=np.int32, device="cpu")
    testee(inp, out=out, offset_provider=prov)
    np.testing.assert_array_equal(
        out.asnumpy(), V2E_TABLE[:, 0] + V2E_TABLE[:, 1]
    )
