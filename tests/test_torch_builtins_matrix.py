"""tests/next_tests/test_builtins_matrix.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

Math-builtin matrix for the field-view layer: every builtin in
MATH_BUILTIN_NAMES, applied (a) eagerly on Fields and (b) inside a
@field_operator, against the NumPy oracle.

Reference pattern: tests/next_tests/integration_tests/feature_tests/
ffront_tests/test_math_builtin_execution.py (one case per builtin over
generated inputs).
"""

import numpy as np
import pytest

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.next import Dimension
from gt4py_tpu_torch.next import fbuiltins

IDim = Dimension("IDim")

# builtin -> (numpy impl, input domain guard)
UNARY = {
    "abs": (np.abs, (-4.0, 4.0)),
    "neg": (np.negative, (-4.0, 4.0)),
    "gamma": (None, (0.5, 4.0)),  # oracle resolved lazily (scipy/math)
    "sin": (np.sin, (-3.0, 3.0)),
    "cos": (np.cos, (-3.0, 3.0)),
    "tan": (np.tan, (-1.0, 1.0)),
    "arcsin": (np.arcsin, (-0.99, 0.99)),
    "arccos": (np.arccos, (-0.99, 0.99)),
    "arctan": (np.arctan, (-4.0, 4.0)),
    "sinh": (np.sinh, (-2.0, 2.0)),
    "cosh": (np.cosh, (-2.0, 2.0)),
    "tanh": (np.tanh, (-3.0, 3.0)),
    "arcsinh": (np.arcsinh, (-4.0, 4.0)),
    "arccosh": (np.arccosh, (1.01, 5.0)),
    "arctanh": (np.arctanh, (-0.99, 0.99)),
    "sqrt": (np.sqrt, (0.0, 9.0)),
    "cbrt": (np.cbrt, (-8.0, 8.0)),
    "exp": (np.exp, (-3.0, 3.0)),
    "log": (np.log, (0.1, 9.0)),
    "floor": (np.floor, (-4.0, 4.0)),
    "ceil": (np.ceil, (-4.0, 4.0)),
    "trunc": (np.trunc, (-4.0, 4.0)),
    "isfinite": (np.isfinite, (-4.0, 4.0)),
    "isinf": (np.isinf, (-4.0, 4.0)),
    "isnan": (np.isnan, (-4.0, 4.0)),
}

def _unary_oracle(name, np_fn):
    if np_fn is not None:
        return np_fn
    assert name == "gamma"
    import math

    return np.vectorize(math.gamma)


BINARY = {
    "minimum": np.minimum,
    "maximum": np.maximum,
    "fmod": np.mod,
    "power": np.power,
}


def _input(lo, hi, n=32, seed=1):
    rng = np.random.default_rng(seed)
    return lo + (hi - lo) * rng.random(n, dtype=np.float64)


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_builtin_eager(name):
    np_fn, (lo, hi) = UNARY[name]
    np_fn = _unary_oracle(name, np_fn)
    data = _input(lo, hi)
    f = gtx.as_field([IDim], data, device="cpu")
    res = getattr(fbuiltins, name)(f)
    np.testing.assert_allclose(np.asarray(res.ndarray), np_fn(data), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_builtin_operator(name):
    np_fn, (lo, hi) = UNARY[name]
    np_fn = _unary_oracle(name, np_fn)
    impl = getattr(fbuiltins, name)

    @gtx.field_operator
    def op(x):
        return impl(x)

    data = _input(lo, hi)
    f = gtx.as_field([IDim], data, device="cpu")
    expect = np_fn(data)
    out = gtx.zeros({IDim: data.size}, dtype=np.asarray(expect).dtype, device="cpu")
    op(f, out=out)
    np.testing.assert_allclose(np.asarray(out.ndarray), expect, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_builtin_eager(name):
    np_fn = BINARY[name]
    a = _input(0.5, 4.0, seed=2)
    b = _input(0.5, 3.0, seed=3)
    fa = gtx.as_field([IDim], a, device="cpu")
    fb = gtx.as_field([IDim], b, device="cpu")
    res = getattr(fbuiltins, name)(fa, fb)
    np.testing.assert_allclose(np.asarray(res.ndarray), np_fn(a, b), rtol=1e-6)


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_builtin_field_scalar(name):
    np_fn = BINARY[name]
    a = _input(0.5, 4.0, seed=4)
    fa = gtx.as_field([IDim], a, device="cpu")
    res = getattr(fbuiltins, name)(fa, 2.0)
    np.testing.assert_allclose(np.asarray(res.ndarray), np_fn(a, 2.0), rtol=1e-6)
    res_r = getattr(fbuiltins, name)(2.0, fa)
    np.testing.assert_allclose(np.asarray(res_r.ndarray), np_fn(2.0, a), rtol=1e-6)


def test_builtin_names_complete():
    """Every name in MATH_BUILTIN_NAMES exists and is covered here."""
    assert set(fbuiltins.MATH_BUILTIN_NAMES) == set(UNARY) | set(BINARY)
    for name in fbuiltins.MATH_BUILTIN_NAMES:
        assert callable(getattr(fbuiltins, name))


def test_astype_tuple_overload():
    """Tuple overload (reference fbuiltins astype on tuples)."""
    f = gtx.as_field([IDim], np.arange(4.0), device="cpu")
    r32 = fbuiltins.astype((f, f * 2.0), np.float32)
    assert isinstance(r32, tuple)
    assert r32[0].dtype == np.dtype(np.float32)
    assert r32[1].dtype == np.dtype(np.float32)
    np.testing.assert_allclose(np.asarray(r32[1].ndarray), 2 * np.arange(4, dtype=np.float32))


def test_where_tuple_overload():
    f = gtx.as_field([IDim], np.arange(4.0), device="cpu")
    cond = f > 1.5
    hi, lo = fbuiltins.where(cond, (f, f * 2.0), (f * 0.0, f * 0.0 - 1.0))
    np.testing.assert_allclose(
        np.asarray(hi.ndarray), np.where(np.arange(4) > 1.5, np.arange(4.0), 0.0)
    )
    np.testing.assert_allclose(
        np.asarray(lo.ndarray), np.where(np.arange(4) > 1.5, 2.0 * np.arange(4), -1.0)
    )
    with pytest.raises(TypeError, match="matching structure"):
        fbuiltins.where(cond, (f,), (f, f))
