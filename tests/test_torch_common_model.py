"""tests/next_tests/test_common_model.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

Core model unit tests: UnitRange / NamedRange / Domain / promote_dims /
connectivities (reference tests/next_tests/unit_tests/test_common.py —
the reference's ~1 kLoC range/domain algebra suite)."""

import numpy as np
import pytest

from gt4py_tpu_torch.next.common import (
    CartesianConnectivity,
    Connectivity,
    DimCondition,
    Dimension,
    DimensionKind,
    Domain,
    NamedRange,
    UnitRange,
    domain,
    promote_dims,
)

I = Dimension("I")
J = Dimension("J")
K = Dimension("K", kind=DimensionKind.VERTICAL)
V2EDim = Dimension("V2E", kind=DimensionKind.LOCAL)


# --- UnitRange ---------------------------------------------------------------


def test_unit_range_basics():
    r = UnitRange(2, 7)
    assert len(r) == 5
    assert 2 in r and 6 in r
    assert 7 not in r and 1 not in r
    assert str(r) == "(2:7)"


def test_unit_range_empty_and_degenerate():
    r = UnitRange(3, 3)
    assert len(r) == 0
    assert 3 not in r


def test_unit_range_from_value_forms():
    assert UnitRange.from_value(5) == UnitRange(0, 5)
    assert UnitRange.from_value((2, 6)) == UnitRange(2, 6)
    assert UnitRange.from_value(range(1, 4)) == UnitRange(1, 4)
    r = UnitRange(0, 3)
    assert UnitRange.from_value(r) is r


def test_unit_range_intersection():
    assert UnitRange(0, 10).intersection(UnitRange(5, 15)) == UnitRange(5, 10)
    assert UnitRange(0, 3).intersection(UnitRange(5, 8)).start >= UnitRange(0, 3).intersection(UnitRange(5, 8)).stop  # empty


def test_unit_range_shifted():
    assert UnitRange(0, 4).shifted(3) == UnitRange(3, 7)
    assert UnitRange(0, 4).shifted(-2) == UnitRange(-2, 2)


def test_unit_range_infinite():
    inf = UnitRange.infinite()
    assert not inf.is_finite
    assert inf.intersection(UnitRange(3, 9)) == UnitRange(3, 9)
    assert UnitRange(3, 9).intersection(inf) == UnitRange(3, 9)


# --- Dimension / NamedRange --------------------------------------------------


def test_dimension_call_builds_named_range():
    # Reference parity: an INT argument builds a NamedIndex (absolute
    # coordinate, common.py:86); range-likes build NamedRanges.
    from gt4py_tpu_torch.next import NamedIndex

    ni_ = I(10)
    assert isinstance(ni_, NamedIndex)
    assert ni_.dim == I and ni_.value == 10
    nr = I((0, 10))
    assert isinstance(nr, NamedRange)
    assert nr.dim == I and nr.unit_range == UnitRange(0, 10)
    nr2 = J((2, 6))
    assert nr2.unit_range == UnitRange(2, 6)


def test_dimension_equality_and_kind():
    assert I == Dimension("I")
    assert I != J
    assert K.kind is DimensionKind.VERTICAL
    assert Dimension("I", DimensionKind.VERTICAL) != I


def test_dimension_int_compare_builds_condition():
    cond = K < 2
    assert isinstance(cond, DimCondition)
    assert cond.dim == K and cond.op == "<" and cond.value == 2
    assert isinstance(K == 0, DimCondition)
    assert isinstance(K >= 5, DimCondition)


# --- Domain ------------------------------------------------------------------


def test_domain_construction_forms():
    d1 = domain({I: 4, J: (1, 5)})
    assert d1.shape == (4, 4)
    assert d1.dims == (I, J)
    d2 = domain([I((0, 4)), J((1, 5))])
    assert d2 == d1
    assert domain(d1) is d1


def test_domain_from_sizes_guides_to_helper():
    # from_sizes cannot resolve bare names to Dimension objects; it points
    # at the domain() helper instead.
    with pytest.raises(TypeError, match="domain"):
        Domain.from_sizes(I=3, J=5)


def test_domain_lookup_and_index():
    d = domain({I: 4, J: 5})
    assert d[I].unit_range == UnitRange(0, 4)
    assert d[1].dim == J
    assert d.index(J) == 1
    assert I in d and K not in d
    with pytest.raises(KeyError):
        d[K]


def test_domain_intersection():
    a = domain({I: (0, 10), J: (0, 10)})
    b = domain({I: (5, 15), J: (2, 8)})
    c = a.intersection(b)
    assert c[I].unit_range == UnitRange(5, 10)
    assert c[J].unit_range == UnitRange(2, 8)


def test_domain_replace():
    d = domain({I: 4, J: 5})
    d2 = d.replace(J, K((0, 7)))
    assert d2.dims == (I, K)
    assert d2[K].unit_range == UnitRange(0, 7)


def test_domain_iter():
    d = domain({I: 2, J: 3})
    assert [nr.dim for nr in d] == [I, J]


# --- promote_dims ------------------------------------------------------------


def test_promote_dims_union_preserves_order():
    assert promote_dims((I, J), (J, K)) == (I, J, K)
    assert promote_dims((I,), (J,)) == (I, J)
    assert promote_dims((), (K,)) == (K,)
    assert promote_dims((I, K), (I, K)) == (I, K)


# --- connectivities ----------------------------------------------------------


def test_connectivity_attributes_and_inverse_image():
    table = np.array([[0, 1], [1, 2], [2, 3], [3, 0]])
    conn = Connectivity(
        table,
        domain_dims=(Dimension("Edge"), V2EDim),
        codomain=Dimension("Vertex"), device="cpu"
    )
    assert conn.max_neighbors == 2
    assert conn.source_dim.value == "Edge"
    rng = conn.inverse_image(UnitRange(0, 2))
    # Rows whose ALL neighbors fall in [0, 2): only row 0 ([0, 1]).
    assert isinstance(rng, UnitRange)
    assert 0 in rng


def test_connectivity_skip_value():
    table = np.array([[0, -1], [1, 0]])
    conn = Connectivity(
        table,
        domain_dims=(Dimension("Edge"), V2EDim),
        codomain=Dimension("Vertex"),
        skip_value=-1, device="cpu"
    )
    assert conn.skip_value == -1


def test_cartesian_connectivity():
    cc = CartesianConnectivity(I, 1)
    assert cc.codomain == I
    assert "I" in repr(cc)


# --- constructor error paths --------------------------------------------------


def test_as_connectivity_requires_two_dims():
    import gt4py_tpu_torch.next as gtx

    with pytest.raises(ValueError, match="source_dim, neighbor_dim"):
        gtx.as_connectivity([I], J, np.zeros((3, 2), dtype=np.int64), device="cpu")


def test_as_field_shape_mismatch_rejected():
    import gt4py_tpu_torch.next as gtx

    with pytest.raises(ValueError, match="shape"):
        gtx.Field(gtx.domain({I: 5}), np.zeros(4))


def test_field_remap_requires_codomain_dim():
    import gt4py_tpu_torch.next as gtx

    conn = gtx.as_connectivity([I, V2EDim], J, np.zeros((3, 2), dtype=np.int64), device="cpu")
    f = gtx.as_field([I], np.zeros(3), device="cpu")  # field over I, conn codomain is J
    with pytest.raises(ValueError, match="cannot be remapped"):
        f(conn)


def test_unit_range_step_rejected():
    with pytest.raises(ValueError, match="step 1"):
        UnitRange.from_value(range(0, 10, 2))
