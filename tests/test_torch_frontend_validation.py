"""tests/next_tests/test_frontend_validation.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

Definition-time DSL validation (reference func_to_foast checks +
errors/exceptions.py): mistakes surface as structured errors with source
locations and did-you-mean suggestions at DECORATION time, not as raw
NameErrors mid-trace."""

import numpy as np
import pytest

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.next import errors
from gt4py_tpu_torch.next.common import Dimension, DimensionKind

I = Dimension("I")
K = Dimension("K", kind=DimensionKind.VERTICAL)


def test_undefined_symbol_reported_at_decoration():
    with pytest.raises(errors.UndefinedSymbolError) as exc:

        @gtx.field_operator
        def op(a, factor: float):
            return a * factorr  # noqa: F821  (typo on purpose)

    msg = str(exc.value)
    assert "factorr" in msg
    assert "Did you mean 'factor'?" in msg
    assert "line" in msg  # formatted with a source location


def test_undefined_symbol_location_points_at_use():
    with pytest.raises(errors.UndefinedSymbolError) as exc:

        @gtx.field_operator
        def op2(a):
            b = a + 1.0
            return b + missing_name  # noqa: F821

    assert exc.value.location is not None
    assert exc.value.location.filename.endswith("test_torch_frontend_validation.py")


def test_locals_and_closures_are_known():
    two = 2.0

    @gtx.field_operator
    def op3(a):
        b = a * two  # closure var
        c = b + 1.0  # local
        return c

    a = gtx.as_field({I: 4}, np.arange(4, dtype=np.float64), device="cpu")
    out = gtx.zeros({I: 4}, dtype=np.float64, device="cpu")
    op3(a, out=out)
    np.testing.assert_allclose(np.asarray(out.asnumpy()), np.arange(4) * 2 + 1)


def test_comprehension_and_lambda_scopes():
    @gtx.program
    def prog(fields, out):
        totals = [f for f in fields]  # comprehension target defined
        for f in totals:
            pass

    assert prog is not None


def test_import_rejected():
    with pytest.raises(errors.DSLSyntaxError, match="Imports"):

        @gtx.field_operator
        def op4(a):
            import os  # noqa: F401

            return a


def test_varargs_rejected():
    with pytest.raises(errors.DSLSyntaxError, match="parameters are not allowed"):

        @gtx.field_operator
        def op5(*fields):
            return fields[0]


def test_scan_operator_validated():
    with pytest.raises(errors.UndefinedSymbolError):

        @gtx.scan_operator(axis=K, init=0.0)
        def scan_bad(carry, x):
            return carry + xx  # noqa: F821


def test_dsl_builtins_are_known_without_import():
    @gtx.field_operator
    def op6(a, b):
        return where(a > b, a, b)  # noqa: F821 (fbuiltins name)

    a = gtx.as_field({I: 3}, np.array([1.0, 5.0, 2.0]), device="cpu")
    b = gtx.as_field({I: 3}, np.array([4.0, 1.0, 3.0]), device="cpu")
    out = gtx.zeros({I: 3}, dtype=np.float64, device="cpu")
    # execution resolves `where` eagerly from the module globals at trace
    # time only if imported — validation must not flag it, execution may.
    assert op6 is not None


# --- program-body lints (PAST-analog, round-3) -------------------------------


def test_program_call_without_out_rejected():
    import pytest

    import gt4py_tpu_torch.next as gtx
    from gt4py_tpu_torch.next.errors import DSLSyntaxError

    @gtx.field_operator
    def _op(a):
        return a + 1.0

    with pytest.raises(DSLSyntaxError, match="out="):

        @gtx.program
        def bad(a, out):
            _op(a)


def test_program_return_rejected():
    import pytest

    import gt4py_tpu_torch.next as gtx
    from gt4py_tpu_torch.next.errors import DSLSyntaxError

    @gtx.field_operator
    def _op2(a):
        return a + 1.0

    with pytest.raises(DSLSyntaxError, match="return"):

        @gtx.program
        def bad2(a, out):
            return _op2(a)


def test_program_dead_expression_rejected():
    import pytest

    import gt4py_tpu_torch.next as gtx
    from gt4py_tpu_torch.next.errors import DSLSyntaxError

    with pytest.raises(DSLSyntaxError, match="no effect"):

        @gtx.program
        def bad3(a, out):
            a + 1.0  # noqa: B018


def test_chained_comparison_raises_at_runtime():
    """`a < b < c` silently evaluated as `b < c` before round 3 (Python
    truth-tests the intermediate Field) — Field.__bool__ now raises with a
    rewrite hint. Chains over compile-time SCALARS stay valid Python, so
    this is a runtime guard, not a decoration-time lint."""
    import numpy as np
    import pytest

    import gt4py_tpu_torch.next as gtx
    from gt4py_tpu_torch.next import Dimension

    I = Dimension("Ichain")

    @gtx.field_operator
    def chained(a, b, c):
        return a < b < c

    f = lambda: gtx.as_field([I], np.ones(4), device="cpu")  # noqa: E731
    out = gtx.zeros({I: 4}, dtype=bool, device="cpu")
    with pytest.raises(TypeError, match="ambiguous"):
        chained(f(), f(), f(), out=out)

    LO, HI = 1, 5

    @gtx.field_operator
    def scalar_chain_ok(a):
        return a * (1.0 if LO < 3 < HI else 0.0)  # scalar chain folds fine

    out2 = gtx.zeros({I: 4}, device="cpu")
    scalar_chain_ok(f(), out=out2)
    np.testing.assert_allclose(np.asarray(out2.ndarray), 1.0)
