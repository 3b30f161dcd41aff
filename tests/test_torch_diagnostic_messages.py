"""tests/next_tests/test_diagnostic_messages.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

Rendered-diagnostic UI tests (ported behaviors from
upstream gt4py tests/next_tests/unit_tests/ffront_tests/
test_diagnostic_messages.py — rustc-style: parse intentionally wrong
operators and pin the rendered text, so error-message quality cannot
silently regress)."""

import re

import numpy as np
import pytest

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.next import errors

IDim = gtx.Dimension("IDim")
F = gtx.Field[gtx.Dims[IDim], np.float64]


def parse_error(func) -> errors.DSLError:
    with pytest.raises(errors.DSLError) as exc_info:
        gtx.field_operator(func)
    return exc_info.value


def test_undeclared_symbol_suggests_close_match():
    def misspelled(temperature: F) -> F:
        tmp_field = temperature * 2.0  # noqa: F841
        return tmp_feild  # noqa: F821

    err = parse_error(misspelled)
    assert isinstance(err, errors.UndefinedSymbolError)
    rendered = str(err)
    assert "tmp_feild" in rendered
    assert "Did you mean 'tmp_field'?" in rendered
    assert "return tmp_feild" in rendered  # source line shown
    assert re.search(r"\^{5,}", rendered), rendered  # caret underline


def test_undeclared_symbol_carries_location():
    def broken(a: F) -> F:
        return zzz_nowhere  # noqa: F821

    err = parse_error(broken)
    assert isinstance(err, errors.UndefinedSymbolError)
    assert err.location is not None
    assert "test_torch_diagnostic_messages.py" in str(err)


def test_loops_fall_back_with_recorded_reason():
    """Unlike the reference (which rejects loops), statically unrollable
    Python control flow executes through the raw-definition fallback and
    the reason is RECORDED on the operator — still a diagnosable state,
    never a silent behavior change."""

    @gtx.field_operator
    def with_for(a: F) -> F:
        acc = a
        for _ in range(3):
            acc = acc + a
        return acc

    n = 6
    a = gtx.as_field([IDim], np.arange(float(n)), device="cpu")
    out = gtx.zeros({IDim: n}, device="cpu")
    with_for(a, out=out, offset_provider={})
    np.testing.assert_allclose(out.asnumpy(), a.asnumpy() * 4.0)
    assert "For" in with_for.__dict__["foast_fallback_reason"]


def test_import_in_body_rejected():
    def with_import(a: F) -> F:
        import os  # noqa: F401

        return a

    err = parse_error(with_import)
    assert "Import" in err.message


def test_bool_field_arithmetic_names_operand_type():
    def bool_arith(a: F, b: F) -> F:
        return (a > b) + 1.0

    err = parse_error(bool_arith)
    assert isinstance(err, errors.DSLTypeError)
    assert "bool" in err.message
    assert "(a > b) + 1.0" in str(err)


def test_program_without_out_named():
    @gtx.field_operator
    def op(a: F) -> F:
        return a

    with pytest.raises(errors.DSLError, match="out=") as exc_info:

        @gtx.program
        def prog(a):
            op(a)

    assert "discarded" in str(exc_info.value)


def test_program_return_rejected():
    @gtx.field_operator
    def op(a: F) -> F:
        return a

    with pytest.raises(errors.DSLError, match="(?i)return"):

        @gtx.program
        def prog(a):
            return op(a)
