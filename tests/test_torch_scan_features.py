"""tests/next_tests/test_scan_features.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

Scan-operator feature depth, ported from the reference suite
(tests/next_tests/integration_tests/feature_tests/ffront_tests/
test_scan.py): scalar scans, nested tuple carries/outputs/inputs,
no-argument scans, vertical-offset compositions, error paths."""

import numpy as np
import pytest

import gt4py_tpu_torch.next as gtx

IDim = gtx.Dimension("IDim")
KDim = gtx.Dimension("KDim", kind=gtx.DimensionKind.VERTICAL)
Koff = gtx.FieldOffset("Koff", source=KDim, target=(KDim,))

ISIZE, KSIZE = 5, 7


def test_scalar_scan():
    """Cumulative sum with a scalar parameter (reference test_scalar_scan)."""

    @gtx.scan_operator(axis=KDim, forward=True, init=0.0)
    def sc(state: float, qc_in: float, scalar: float) -> float:
        return qc_in + state + scalar

    qc = gtx.as_field([IDim, KDim], np.zeros((ISIZE, KSIZE)), device="cpu")
    out = gtx.zeros({IDim: ISIZE, KDim: KSIZE}, device="cpu")
    sc(qc, 1.0, out=out)
    expected = np.tile(np.arange(1.0, KSIZE + 1), (ISIZE, 1))
    np.testing.assert_allclose(out.asnumpy(), expected)


def test_tuple_scalar_scan():
    """A nested scalar tuple rides as one scan argument
    (reference test_tuple_scalar_scan)."""

    @gtx.scan_operator(axis=KDim, forward=True, init=0.0)
    def sc(state: float, qc_in: float, tuple_scalar) -> float:
        return (qc_in + state + tuple_scalar[1][0] + tuple_scalar[1][1]) / tuple_scalar[0]

    qc = gtx.as_field([IDim, KDim], np.zeros((ISIZE, KSIZE)), device="cpu")
    out = gtx.zeros({IDim: ISIZE, KDim: KSIZE}, device="cpu")
    sc(qc, (1.0, (1.0, 0.0)), out=out)
    expected = np.tile(np.arange(1.0, KSIZE + 1), (ISIZE, 1))
    np.testing.assert_allclose(out.asnumpy(), expected)


def test_scalar_scan_vertical_offset():
    """Scan over a shifted field (reference
    test_scalar_scan_vertical_offset)."""

    @gtx.scan_operator(axis=KDim, forward=True, init=0.0)
    def sc(state: float, inp: float) -> float:
        return state + inp

    @gtx.field_operator
    def shifted_sum(inp):
        return sc(inp(Koff[1]))

    inp = gtx.as_field([KDim], np.arange(float(KSIZE)), device="cpu")
    out = gtx.zeros({KDim: KSIZE - 1}, device="cpu")
    shifted_sum(inp, out=out, offset_provider={"Koff": KDim})
    np.testing.assert_allclose(
        out.asnumpy(), np.cumsum(np.arange(1.0, KSIZE))
    )


def test_scan_unused_parameter():
    @gtx.scan_operator(axis=KDim, forward=True, init=0.0)
    def sc(state: float, used: float, unused: float) -> float:
        return state + used

    a = gtx.as_field([KDim], np.ones(KSIZE), device="cpu")
    b = gtx.as_field([KDim], np.full(KSIZE, 99.0), device="cpu")
    out = gtx.zeros({KDim: KSIZE}, device="cpu")
    sc(a, b, out=out)
    np.testing.assert_allclose(out.asnumpy(), np.arange(1.0, KSIZE + 1))


@pytest.mark.parametrize("forward", [True, False])
def test_scan_nested_tuple_output(forward):
    """Nested tuple carries write into nested tuple out fields — with NO
    input arguments at all (reference test_scan_nested_tuple_output)."""

    @gtx.scan_operator(axis=KDim, forward=forward, init=(1, (2, 3)))
    def sc(carry):
        return (carry[0] + 1, (carry[1][0] + 1, carry[1][1] + 1))

    o0 = gtx.zeros({KDim: KSIZE}, dtype=np.int64, device="cpu")
    o1 = gtx.zeros({KDim: KSIZE}, dtype=np.int64, device="cpu")
    o2 = gtx.zeros({KDim: KSIZE}, dtype=np.int64, device="cpu")
    sc(out=(o0, (o1, o2)))
    base = np.arange(1, 1 + KSIZE)
    if not forward:
        base = np.flip(base)
    np.testing.assert_array_equal(o0.asnumpy(), base + 1)
    np.testing.assert_array_equal(o1.asnumpy(), base + 2)
    np.testing.assert_array_equal(o2.asnumpy(), base + 3)


def test_scan_nested_tuple_input():
    """Nested tuple of fields as one argument
    (reference test_scan_nested_tuple_input)."""

    @gtx.scan_operator(axis=KDim, forward=True, init=1.0)
    def sc(state: float, pair) -> float:
        return state + pair[0] * pair[1]

    inp1 = gtx.as_field([KDim], np.ones(KSIZE), device="cpu")
    inp2 = gtx.as_field([KDim], np.arange(0.0, KSIZE), device="cpu")
    out = gtx.zeros({KDim: KSIZE}, device="cpu")
    sc((inp1, inp2), out=out)
    expected = 1.0 + np.cumsum(np.arange(0.0, KSIZE))
    np.testing.assert_allclose(out.asnumpy(), expected)


def test_ternary_scan():
    """max-accumulator via a ternary on per-level values
    (reference test_ternary_scan)."""

    @gtx.scan_operator(axis=KDim, forward=True, init=0.0)
    def sc(carry: float, a: float) -> float:
        return carry if carry > a else a

    a_np = np.asarray([2.0, 1.0, 5.0, 3.0, 7.0, 0.0, 6.0])
    a = gtx.as_field([KDim], a_np, device="cpu")
    out = gtx.zeros({KDim: KSIZE}, device="cpu")
    sc(a, out=out)
    np.testing.assert_allclose(out.asnumpy(), np.maximum.accumulate(a_np))


def test_scan_tuple_field_scalar_mixed():
    """Mixed tuple argument (field, scalar) — reference
    test_scan_tuple_field_scalar_mixed."""

    @gtx.scan_operator(axis=KDim, forward=True, init=0.0)
    def sc(state: float, mixed) -> float:
        return state + mixed[0] + mixed[1]

    f = gtx.as_field([KDim], np.ones(KSIZE), device="cpu")
    out = gtx.zeros({KDim: KSIZE}, device="cpu")
    sc((f, 2.0), out=out)
    np.testing.assert_allclose(out.asnumpy(), 3.0 * np.arange(1.0, KSIZE + 1))
