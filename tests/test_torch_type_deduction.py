"""tests/next_tests/test_type_deduction.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

Definition-time type deduction tests (reference
tests/next_tests/unit_tests/ffront_tests/test_foast_pretty_printer.py +
foast_passes type-deduction suites: annotated operators are type-checked
over their AST before any trace; mistakes raise structured DSLTypeError
with source locations)."""

import numpy as np
import pytest

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.next import (
    Dimension,
    DimensionKind,
    Dims,
    Field,
    FieldOffset,
    broadcast,
    neighbor_sum,
    where,
)
from gt4py_tpu_torch.next.errors import (
    DSLTypeError,
    MissingParameterAnnotationError,
)
from gt4py_tpu_torch.next.type_deduction import deduce

I = Dimension("I")
J = Dimension("J")
K = Dimension("K", kind=DimensionKind.VERTICAL)
Vertex = Dimension("Vertex")
Edge = Dimension("Edge")
E2VDim = Dimension("E2V", kind=DimensionKind.LOCAL)

Ioff = FieldOffset("Ioff", source=I, target=(I,))
E2V = FieldOffset("E2V", source=Vertex, target=(Edge, E2VDim))

F64_IJ = Field[Dims[I, J], np.float64]
F64_I = Field[Dims[I], np.float64]


# --- deduction of well-typed operators --------------------------------------


def test_deduce_simple():
    def lap(phi: F64_IJ) -> F64_IJ:
        return -4.0 * phi + phi(Ioff[1]) + phi(Ioff[-1])

    info = deduce(lap)
    assert info is not None
    assert str(info.params["phi"]) == "Field[[I, J], float64]"
    assert str(info.returns) == "Field[[I, J], float64]"


def test_deduce_skipped_without_annotations():
    def legacy(phi):
        return phi * 2.0

    assert deduce(legacy) is None


def test_weak_literal_keeps_float32():
    def scale(phi: Field[Dims[I], np.float32]):
        return phi * 2.0

    info = deduce(scale)
    assert info.returns.dtype == np.dtype(np.float32)


def test_cross_kind_literal_promotes_int_field():
    def f(n: Field[Dims[I], np.int32]):
        return n * 2.5

    info = deduce(f)
    assert info.returns.dtype.kind == "f"


def test_dims_promotion_in_binop():
    def f(a: Field[Dims[I], np.float64], b: Field[Dims[J], np.float64]):
        return a + b

    info = deduce(f)
    assert set(info.returns.dims) == {I, J}


def test_unstructured_remap_changes_dims():
    def f(v: Field[Dims[Vertex], np.float64]):
        return v(E2V)

    info = deduce(f)
    assert info.returns.dims == (Edge, E2VDim)


def test_neighbor_sum_removes_local_dim():
    def f(v: Field[Dims[Vertex], np.float64]):
        return neighbor_sum(v(E2V), axis=E2VDim)

    info = deduce(f)
    assert info.returns.dims == (Edge,)


def test_tuple_return_and_unpack():
    def f(a: F64_I):
        x, y = a + 1.0, a - 1.0
        return x, y

    info = deduce(f)
    assert len(info.returns.types) == 2


def test_comparison_yields_bool_field():
    def f(a: F64_I):
        return a > 0.0

    info = deduce(f)
    assert info.returns.dtype == np.dtype(bool)


def test_where_promotes_operands():
    def f(a: F64_I, b: Field[Dims[I], np.float32]):
        return where(a > 0.0, a, b)

    info = deduce(f)
    assert info.returns.dtype == np.dtype(np.float64)
    assert info.returns.dims == (I,)


def test_operator_call_propagates_deduced_return():
    @gtx.field_operator
    def inner(a: F64_I) -> F64_I:
        return a * 2.0

    def outer(a: F64_I):
        return inner(a) + 1.0

    info = deduce(outer)
    assert str(info.returns) == "Field[[I], float64]"


# --- definition-time errors --------------------------------------------------


def test_bool_arithmetic_rejected():
    with pytest.raises(DSLTypeError, match="not defined for bool"):

        @gtx.field_operator
        def bad(a: Field[Dims[I], bool], b: F64_I):
            return a + b


def test_shift_missing_dimension_rejected():
    with pytest.raises(DSLTypeError, match="Cannot shift along I"):

        @gtx.field_operator
        def bad(a: Field[Dims[J], np.float64]):
            return a(Ioff[1])


def test_remap_missing_source_rejected():
    with pytest.raises(DSLTypeError, match="no Vertex dimension"):

        @gtx.field_operator
        def bad(e: Field[Dims[Edge], np.float64]):
            return e(E2V)


def test_reduction_over_non_local_rejected():
    with pytest.raises(DSLTypeError, match="LOCAL"):

        @gtx.field_operator
        def bad(a: F64_IJ):
            return neighbor_sum(a, axis=J)


def test_reduction_over_missing_dim_rejected():
    with pytest.raises(DSLTypeError, match="no such dimension"):

        @gtx.field_operator
        def bad(a: F64_I):
            return neighbor_sum(a, axis=E2VDim)


def test_return_annotation_mismatch_rejected():
    with pytest.raises(DSLTypeError, match="Declared return type"):

        @gtx.field_operator
        def bad(a: F64_I) -> Field[Dims[I], np.int32]:
            return a + 1.0


def test_conflicting_returns_rejected():
    with pytest.raises(DSLTypeError, match="conflicts with an earlier return"):

        @gtx.field_operator
        def bad(a: F64_I, flag: bool):
            if flag:
                return a
            return (a, a)


def test_and_on_non_bool_rejected():
    with pytest.raises(DSLTypeError, match="must be bool"):

        @gtx.field_operator
        def bad(a: F64_I):
            return a and a


def test_field_condition_in_if_rejected():
    with pytest.raises(DSLTypeError, match="scalar bool"):

        @gtx.field_operator
        def bad(a: F64_I):
            if a > 0.0:
                a = a + 1.0
            return a


def test_ternary_field_condition_rejected():
    with pytest.raises(DSLTypeError, match="where"):

        @gtx.field_operator
        def bad(a: F64_I):
            return a if a > 0.0 else -a


def test_broadcast_cannot_drop_dims():
    with pytest.raises(DSLTypeError, match="cannot drop"):

        @gtx.field_operator
        def bad(a: F64_IJ):
            return broadcast(a, (I,))


def test_nested_operator_arg_mismatch_rejected():
    @gtx.field_operator
    def inner(a: F64_I) -> F64_I:
        return a * 2.0

    with pytest.raises(DSLTypeError, match="expected Field"):

        @gtx.field_operator
        def bad(b: Field[Dims[J], np.float64]):
            return inner(b)


def test_partial_annotations_rejected():
    with pytest.raises(MissingParameterAnnotationError):

        @gtx.field_operator
        def bad(a: F64_I, b):
            return a + b


def test_error_carries_source_location():
    try:

        @gtx.field_operator
        def bad(a: Field[Dims[I], bool], b: F64_I):
            return a + b

        raise AssertionError("expected DSLTypeError")
    except DSLTypeError as e:
        assert e.location is not None
        assert e.location.filename.endswith("test_torch_type_deduction.py")


# --- call-time validation -----------------------------------------------------


@gtx.field_operator
def _scale2(phi: F64_I) -> F64_I:
    return phi * 2.0


def test_call_time_dim_mismatch():
    f = gtx.as_field([J], np.ones(4), device="cpu")
    out = gtx.zeros({I: 4}, device="cpu")
    with pytest.raises(DSLTypeError, match="expected Field"):
        _scale2(f, out=out)


def test_call_time_dtype_mismatch():
    f = gtx.as_field([I], np.ones(4, np.float32), device="cpu")
    out = gtx.zeros({I: 4}, device="cpu")
    with pytest.raises(DSLTypeError, match="float64"):
        _scale2(f, out=out)


def test_call_time_valid_passes():
    f = gtx.as_field([I], np.arange(4.0), device="cpu")
    out = gtx.zeros({I: 4}, device="cpu")
    _scale2(f, out=out)
    np.testing.assert_allclose(out.asnumpy(), 2 * np.arange(4.0))


def test_scan_operator_call_time_check():
    @gtx.scan_operator(axis=K, forward=True, init=0.0)
    def cumsum(carry: float, x: float):
        return carry + x

    data = np.arange(5.0)
    f = gtx.as_field([K], data, device="cpu")
    out = gtx.zeros({K: 5}, device="cpu")
    cumsum(f, out=out)
    np.testing.assert_allclose(out.asnumpy(), np.cumsum(data))

    bad = gtx.as_field([K], np.ones(5, np.float32), device="cpu")
    with pytest.raises(DSLTypeError, match="float64"):
        cumsum(bad, out=out)


def test_out_dims_validated_against_return():
    out_bad = gtx.zeros({I: 4, J: 4}, device="cpu")
    f = gtx.as_field([I], np.arange(4.0), device="cpu")
    with pytest.raises(DSLTypeError, match="not produced by the operator"):
        _scale2(f, out=out_bad)


def test_out_non_field_rejected():
    f = gtx.as_field([I], np.arange(4.0), device="cpu")
    with pytest.raises(DSLTypeError, match="must be a Field"):
        _scale2(f, out=np.zeros(4))


def test_out_subdomain_accepted():
    # out over a SUBSET of the return dims/extent is fine (partial write).
    f = gtx.as_field([I], np.arange(6.0), device="cpu")
    out = gtx.zeros({I: (1, 5)}, device="cpu")
    _scale2(f, out=out)
    np.testing.assert_allclose(out.asnumpy(), 2 * np.arange(1.0, 5.0))


def test_multi_offset_shift_deduces():
    def f(a: F64_I):
        return a(Ioff[1], Ioff[1]) - 2.0 * a(Ioff[1]) + a

    info = deduce(f)
    assert str(info.returns) == "Field[[I], float64]"
