"""tests/next_tests/test_arg_call_interface.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

Argument/call-interface parity (reference test_arg_call_interface.py):
kwargs in any position, domain args with tuple returns, missing-argument
errors, scan-from-program, nested-call kwargs."""

import numpy as np
import pytest

import gt4py_tpu_torch.next as gtx

I = gtx.Dimension("Iai")
K = gtx.Dimension("Kai", kind=gtx.DimensionKind.VERTICAL)

def test_operator_call_with_kwargs_only():
    @gtx.field_operator
    def op(a, b):
        return a + b
    fa = gtx.as_field([I], np.ones(3), device="cpu"); fb = gtx.as_field([I], np.full(3, 2.0), device="cpu")
    out = gtx.zeros({I: 3}, device="cpu")
    op(b=fb, a=fa, out=out)
    assert (out.asnumpy() == 3.0).all()


def test_program_call_with_kwargs_only():
    @gtx.field_operator
    def op(a, b):
        return a + b
    @gtx.program
    def prog(a, b, out):
        op(a, b, out=out)
    fa = gtx.as_field([I], np.ones(3), device="cpu"); fb = gtx.as_field([I], np.full(3, 2.0), device="cpu")
    out = gtx.zeros({I: 3}, device="cpu")
    prog(b=fb, out=out, a=fa)
    assert (out.asnumpy() == 3.0).all()


def test_domain_arg_with_tuple_return():
    @gtx.field_operator
    def op(a):
        return (a + 1.0, a + 2.0)
    fa = gtx.as_field([I], np.zeros(6), device="cpu")
    o1 = gtx.zeros({I: 6}, device="cpu"); o2 = gtx.zeros({I: 6}, device="cpu")
    op(fa, out=(o1, o2), domain={I: (1, 4)})
    assert (o1.asnumpy()[1:4] == 1.0).all() and (o1.asnumpy()[0] == 0.0)
    assert (o2.asnumpy()[1:4] == 2.0).all()


def test_missing_operator_arg_raises():
    @gtx.field_operator
    def op(a, b):
        return a + b
    fa = gtx.as_field([I], np.ones(3), device="cpu")
    out = gtx.zeros({I: 3}, device="cpu")
    try:
        op(fa, out=out)
    except Exception:
        return
    raise AssertionError("missing arg accepted")


def test_missing_scan_arg_raises():
    @gtx.scan_operator(axis=K, forward=True, init=0.0)
    def sc(st, a):
        return st + a
    f = gtx.as_field([K], np.ones(4), device="cpu")
    out = gtx.zeros({K: 4}, device="cpu")
    try:
        sc(out=out)
    except Exception:
        return
    raise AssertionError("missing scan arg accepted")


def test_scan_called_from_program():
    @gtx.scan_operator(axis=K, forward=True, init=0.0)
    def sc(st, a):
        return st + a
    @gtx.program
    def prog(a, out):
        sc(a, out=out)
    f = gtx.as_field([K], np.ones(4), device="cpu")
    out = gtx.zeros({K: 4}, device="cpu")
    prog(f, out)
    np.testing.assert_allclose(out.asnumpy(), np.arange(1.0, 5.0))


def test_kwargs_in_nested_operator_call():
    @gtx.field_operator
    def inner(a, w):
        return a * w
    @gtx.field_operator
    def outer(a):
        return inner(w=2.0, a=a)
    f = gtx.as_field([I], np.ones(3), device="cpu")
    out = gtx.zeros({I: 3}, device="cpu")
    outer(f, out=out)
    assert (out.asnumpy() == 2.0).all()

