"""The port's mesh utilities (gt4py_tpu_torch.next.mesh_utils) against the
JAX package's (tests/next_tests/test_mesh_utils.py).

Ported: the tiled renumbering, the permutation checks, skip values through
relabelling and the invariance of a neighbour sum under renumbering, each
also held against the JAX package's result; and the FVM-nabla mesh
generator, ``periodic_quad_mesh``, equal to the JAX package's. Left out:
``test_row_major_mesh_engages`` and
``test_scrambled_mesh_recovered_by_spatial_renumbering``, whose subject is
``shift_structure_report`` — the diagnostics of the JAX package's roll plan
(``embedded._shift_plan``), a TPU workaround the port does not have (a
remap here is one gather, whatever the numbering).
"""

import numpy as np
import pytest

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.next import (
    Dimension,
    DimensionKind,
    FieldOffset,
    Renumbering,
    neighbor_sum,
    spatial_renumbering,
)
from gt4py_tpu_torch.next.mesh_utils import periodic_quad_mesh

from .next_tests.test_mesh_utils import quad_mesh_v2v

V = Dimension("V")
V2VDim = Dimension("V2V", kind=DimensionKind.LOCAL)


def _ref():
    from gt4py_tpu.next import mesh_utils

    return mesh_utils


@pytest.mark.parametrize("n", [3, 16])
def test_periodic_quad_mesh_matches_reference(n):
    for mine, ref in zip(periodic_quad_mesh(n), _ref().periodic_quad_mesh(n)):
        assert mine.dtype == ref.dtype
        np.testing.assert_array_equal(mine, ref)


def test_tiled_renumbering_orders_by_tile():
    coords = np.array([[0, 0], [0, 5], [1, 0], [1, 5]])
    perm = spatial_renumbering(coords, tile=(2, 4))
    assert np.argsort(perm).tolist() == [0, 2, 1, 3]
    np.testing.assert_array_equal(perm, _ref().spatial_renumbering(coords, tile=(2, 4)))


def test_spatial_renumbering_matches_reference():
    _, coords = quad_mesh_v2v(8)
    scrambled = coords[np.random.default_rng(3).permutation(64)]
    np.testing.assert_array_equal(
        spatial_renumbering(scrambled), _ref().spatial_renumbering(scrambled))


def test_renumbering_validates_and_inverts():
    with pytest.raises(ValueError):
        Renumbering(V, np.array([0, 0, 1]))
    r = Renumbering(V, np.array([2, 0, 1]))
    assert r.inverse.tolist() == [1, 2, 0]
    np.testing.assert_array_equal(r.permute_data(np.array([10.0, 20.0, 30.0])), [20.0, 30.0, 10.0])


def test_skip_values_survive_relabeling():
    table = np.array([[1, -1], [0, -1]])
    conn = gtx.as_connectivity([V, V2VDim], V, table, skip_value=-1, device="cpu")
    out = Renumbering(V, np.array([1, 0])).apply(conn)
    t = out.table.numpy()
    assert out.table.device.type == "cpu"  # the relabelled table stays where it was
    assert (t[:, 1] == -1).all()
    assert t[1, 0] == 0 and t[0, 0] == 1


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_neighbor_sum_invariant_under_renumbering(backend):
    """Renumbering is a pure relabelling: the result at element x is
    unchanged, stored at its new position (rtol 1e-6 in float32, as the
    JAX package's test)."""
    m = 8
    n = m * m
    table, _ = quad_mesh_v2v(m)
    rng = np.random.default_rng(23)
    ren = Renumbering(V, rng.permutation(n))
    V2V = FieldOffset("V2V", source=V, target=(V, V2VDim))

    @gtx.field_operator
    def nbsum(f):
        return neighbor_sum(f(V2V), axis=V2VDim)

    op = nbsum.with_backend(backend)
    data = rng.random(n).astype(np.float32)
    conn_a = gtx.as_connectivity([V, V2VDim], V, table, device="cpu")
    out_a = gtx.zeros(gtx.domain({V: n}), dtype=np.float32, device="cpu")
    op(gtx.as_field([V], data, device="cpu"), out=out_a, offset_provider={"V2V": conn_a})
    out_b = gtx.zeros(gtx.domain({V: n}), dtype=np.float32, device="cpu")
    op(gtx.as_field([V], ren.permute_data(data).copy(), device="cpu"), out=out_b,
       offset_provider={"V2V": ren.apply(conn_a)})
    np.testing.assert_allclose(ren.permute_data(out_a.ndarray), out_b.asnumpy(), rtol=1e-6)
