"""tests/next_tests/test_type_conversion.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

Type-conversion and conditional idioms from the reference feature
suites (test_type_conversion.py, test_conditionals.py uses_if_stmts)."""

import numpy as np
import pytest

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.next import astype, int32, int64, float32, float64

I = gtx.Dimension("Itc")
K = gtx.Dimension("Ktc", kind=gtx.DimensionKind.VERTICAL)


def test_type_constructor_casts_field():
    """``int64(inp)`` inside an operator casts (reference
    test_astype_int / type-builtin constructors)."""

    @gtx.field_operator
    def conv(a):
        return int64(a)

    f = gtx.as_field([I], np.arange(4, dtype=np.int32), device="cpu")
    out = gtx.zeros({I: 4}, dtype=np.int64, device="cpu")
    conv(f, out=out)
    assert out.asnumpy().dtype == np.int64
    np.testing.assert_array_equal(out.asnumpy(), np.arange(4))


def test_type_constructor_on_scalars_and_dtype_protocol():
    assert float64(1) == np.float64(1.0)
    assert isinstance(int32(7), np.int32)
    assert np.dtype(float32) == np.dtype(np.float32)
    # usable anywhere a dtype is expected
    f = gtx.zeros({I: 3}, dtype=float32, device="cpu")
    assert f.dtype == np.float32


def test_type_constructor_in_scan_body():
    @gtx.scan_operator(axis=K, forward=True, init=0.0)
    def sc(state: float, a: int32) -> float:
        return state + float64(a)

    f = gtx.as_field([K], np.arange(5, dtype=np.int32), device="cpu")
    out = gtx.zeros({K: 5}, device="cpu")
    sc(f, out=out)
    np.testing.assert_allclose(out.asnumpy(), np.cumsum(np.arange(5.0)))


def test_astype_bool_and_back():
    @gtx.field_operator
    def roundtrip(a):
        return astype(astype(a, bool), float64)

    f = gtx.as_field([I], np.array([0.0, 2.5, 0.0, -1.0]), device="cpu")
    out = gtx.zeros({I: 4}, device="cpu")
    roundtrip(f, out=out)
    np.testing.assert_array_equal(out.asnumpy(), [0.0, 1.0, 0.0, 1.0])


def test_if_stmt_runtime_bool_scalar():
    """``if flag:`` with a runtime bool argument works under the jitted
    path (reference uses_if_stmts; lowered to per-name selects when the
    condition is traced)."""

    @gtx.field_operator
    def cond_op(a, flag: bool):
        if flag:
            res = a + 1.0
        else:
            res = a - 1.0
        return res

    f = gtx.as_field([I], np.zeros(3), device="cpu")
    out = gtx.zeros({I: 3}, device="cpu")
    cond_op(f, True, out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.ones(3))
    cond_op(f, False, out=out)
    np.testing.assert_array_equal(out.asnumpy(), -np.ones(3))


def test_if_stmt_partial_assignment_and_updates():
    """One branch updates, the other leaves the outer binding; both
    branches may read-before-write."""

    @gtx.field_operator
    def partial(a, flag: bool):
        res = a * 2.0
        if flag:
            res = res + 10.0
            extra = res * 0.0 + 5.0
        else:
            extra = res * 0.0
        return res + extra

    f = gtx.as_field([I], np.ones(4), device="cpu")
    out = gtx.zeros({I: 4}, device="cpu")
    partial(f, True, out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.full(4, 17.0))
    partial(f, False, out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.full(4, 2.0))


def test_if_stmt_nested():
    @gtx.field_operator
    def nested(a, p: bool, q: bool):
        if p:
            if q:
                r = a + 1.0
            else:
                r = a + 2.0
        else:
            r = a + 3.0
        return r

    f = gtx.as_field([I], np.zeros(2), device="cpu")
    out = gtx.zeros({I: 2}, device="cpu")
    for p, q, want in ((True, True, 1.0), (True, False, 2.0), (False, True, 3.0)):
        nested(f, p, q, out=out)
        np.testing.assert_array_equal(out.asnumpy(), np.full(2, want))


def test_if_stmt_python_bool_short_circuit():
    """Compile-time Python bools keep one-branch execution: the untaken
    branch may contain calls invalid for this configuration."""
    FLAG = True

    @gtx.field_operator
    def guarded(a):
        if FLAG:
            r = a * 2.0
        else:
            r = a[999]  # invalid restriction — must never evaluate
        return r

    f = gtx.as_field([I], np.ones(3), device="cpu")
    out = gtx.zeros({I: 3}, device="cpu")
    guarded(f, out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.full(3, 2.0))
