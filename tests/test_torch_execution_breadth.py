"""tests/next_tests/test_execution_breadth.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

Field-operator execution breadth (reference
tests/next_tests/integration_tests/feature_tests/ffront_tests/
test_execution.py — the reference's ~3 kLoC operator-semantics suite):
tuples, conditionals, scans with tuple carries, nested calls, casts,
broadcasts, domain arguments, program composition."""

import numpy as np
import pytest

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.next import (
    Dimension,
    DimensionKind,
    FieldOffset,
    astype,
    broadcast,
    where,
)

I = Dimension("I")
J = Dimension("J")
K = Dimension("K", kind=DimensionKind.VERTICAL)
Ioff = FieldOffset("Ioff", source=I, target=(I,))

PROV = {"Ioff": I}


@pytest.fixture
def rng():
    return np.random.default_rng(7)


# --- tuples -------------------------------------------------------------------


def test_tuple_output(rng):
    @gtx.field_operator
    def minmax(a, b):
        return where(a > b, a, b), where(a > b, b, a)

    av, bv = rng.random(8), rng.random(8)
    fa, fb = gtx.as_field([I], av, device="cpu"), gtx.as_field([I], bv, device="cpu")
    hi, lo = gtx.zeros({I: 8}, device="cpu"), gtx.zeros({I: 8}, device="cpu")
    minmax(fa, fb, out=(hi, lo))
    np.testing.assert_allclose(hi.asnumpy(), np.maximum(av, bv))
    np.testing.assert_allclose(lo.asnumpy(), np.minimum(av, bv))


def test_tuple_unpack_inside_operator(rng):
    @gtx.field_operator
    def swap_sum(a, b):
        x, y = b, a
        return x + 2.0 * y

    av, bv = rng.random(6), rng.random(6)
    out = gtx.zeros({I: 6}, device="cpu")
    swap_sum(gtx.as_field([I], av, device="cpu"), gtx.as_field([I], bv, device="cpu"), out=out)
    np.testing.assert_allclose(out.asnumpy(), bv + 2.0 * av)


def test_nested_tuple_return(rng):
    @gtx.field_operator
    def pair_and_scale(a):
        return (a, (a * 2.0, a * 3.0))

    av = rng.random(5)
    o1 = gtx.zeros({I: 5}, device="cpu")
    o2 = gtx.zeros({I: 5}, device="cpu")
    o3 = gtx.zeros({I: 5}, device="cpu")
    pair_and_scale(gtx.as_field([I], av, device="cpu"), out=(o1, (o2, o3)))
    np.testing.assert_allclose(o2.asnumpy(), 2 * av)
    np.testing.assert_allclose(o3.asnumpy(), 3 * av)


# --- conditionals / where chains ---------------------------------------------


def test_where_chain(rng):
    @gtx.field_operator
    def clamp01(a):
        return where(a < 0.0, 0.0, where(a > 1.0, 1.0, a))

    av = rng.random(10) * 3.0 - 1.0
    out = gtx.zeros({I: 10}, device="cpu")
    clamp01(gtx.as_field([I], av, device="cpu"), out=out)
    np.testing.assert_allclose(out.asnumpy(), np.clip(av, 0.0, 1.0))


def test_scalar_if_branch_static_param(rng):
    """Python-level branching on a scalar needs the parameter declared
    static (baked per compiled variant — reference static_params)."""

    @gtx.field_operator
    def pick(a, up: bool):
        if up:
            return a + 1.0
        return a - 1.0

    op = pick.with_compilation_options(static_params=("up",))
    av = rng.random(4)
    out = gtx.zeros({I: 4}, device="cpu")
    op(gtx.as_field([I], av, device="cpu"), up=True, out=out)
    np.testing.assert_allclose(out.asnumpy(), av + 1.0)
    op(gtx.as_field([I], av, device="cpu"), up=False, out=out)
    np.testing.assert_allclose(out.asnumpy(), av - 1.0)


# --- casts / broadcasts -------------------------------------------------------


def test_astype_roundtrip(rng):
    @gtx.field_operator
    def quantize(a):
        return astype(astype(a * 10.0, np.int32), np.float64)

    av = rng.random(6)
    out = gtx.zeros({I: 6}, device="cpu")
    quantize(gtx.as_field([I], av, device="cpu"), out=out)
    np.testing.assert_allclose(out.asnumpy(), (av * 10.0).astype(np.int32))


def test_broadcast_to_higher_rank(rng):
    @gtx.field_operator
    def expand(a):
        return broadcast(a, (I, J))

    av = rng.random(4)
    out = gtx.zeros({I: 4, J: 3}, device="cpu")
    expand(gtx.as_field([I], av, device="cpu"), out=out)
    np.testing.assert_allclose(out.asnumpy(), np.broadcast_to(av[:, None], (4, 3)))


def test_scalar_broadcast_arithmetic(rng):
    @gtx.field_operator
    def axpy(a, x, alpha: float):
        return alpha * a + x

    av, xv = rng.random(7), rng.random(7)
    out = gtx.zeros({I: 7}, device="cpu")
    axpy(gtx.as_field([I], av, device="cpu"), gtx.as_field([I], xv, device="cpu"), alpha=2.5, out=out)
    np.testing.assert_allclose(out.asnumpy(), 2.5 * av + xv)


# --- scans --------------------------------------------------------------------


def test_scan_tuple_carry(rng):
    @gtx.scan_operator(axis=K, forward=True, init=(0.0, 0.0))
    def running(carry, x):
        total, count = carry
        return (total + x, count + 1.0)

    xv = rng.random(6)
    f = gtx.as_field([K], xv, device="cpu")
    tot = gtx.zeros({K: 6}, device="cpu")
    cnt = gtx.zeros({K: 6}, device="cpu")
    running(f, out=(tot, cnt))
    np.testing.assert_allclose(tot.asnumpy(), np.cumsum(xv))
    np.testing.assert_allclose(cnt.asnumpy(), np.arange(1.0, 7.0))


def test_backward_scan(rng):
    @gtx.scan_operator(axis=K, forward=False, init=0.0)
    def suffix_sum(carry, x):
        return carry + x

    xv = rng.random(5)
    out = gtx.zeros({K: 5}, device="cpu")
    suffix_sum(gtx.as_field([K], xv, device="cpu"), out=out)
    np.testing.assert_allclose(out.asnumpy(), np.cumsum(xv[::-1])[::-1])


def test_scan_vectorized_over_horizontal(rng):
    @gtx.scan_operator(axis=K, forward=True, init=0.0)
    def cumsum(carry, x):
        return carry + x

    xv = rng.random((4, 5))
    out = gtx.zeros({I: 4, K: 5}, device="cpu")
    cumsum(gtx.as_field([I, K], xv, device="cpu"), out=out)
    np.testing.assert_allclose(out.asnumpy(), np.cumsum(xv, axis=1))


# --- composition --------------------------------------------------------------


def test_operator_calling_operator_with_shift(rng):
    @gtx.field_operator
    def grad(a):
        return a(Ioff[1]) - a

    @gtx.field_operator
    def grad2(a):
        return grad(grad(a))

    av = rng.random(9)
    out = gtx.zeros({I: (0, 7)}, device="cpu")
    grad2(gtx.as_field([I], av, device="cpu"), out=out, offset_provider=PROV)
    np.testing.assert_allclose(out.asnumpy(), np.diff(np.diff(av)), atol=1e-12)


def test_program_composes_operators(rng):
    @gtx.field_operator
    def dbl(a):
        return a * 2.0

    @gtx.field_operator
    def inc(a):
        return a + 1.0

    @gtx.program
    def pipeline(a, tmp, out):
        dbl(a, out=tmp)
        inc(tmp, out=out)

    av = rng.random(6)
    tmp = gtx.zeros({I: 6}, device="cpu")
    out = gtx.zeros({I: 6}, device="cpu")
    pipeline(gtx.as_field([I], av, device="cpu"), tmp, out)
    np.testing.assert_allclose(out.asnumpy(), 2 * av + 1.0)


def test_domain_argument_restricts_write(rng):
    @gtx.field_operator
    def fill7(a):
        return a * 0.0 + 7.0

    av = rng.random(8)
    out = gtx.zeros({I: 8}, device="cpu")
    fill7(gtx.as_field([I], av, device="cpu"), out=out, domain={I: (2, 5)})
    expected = np.zeros(8)
    expected[2:5] = 7.0
    np.testing.assert_allclose(out.asnumpy(), expected)


def test_math_builtins_compose(rng):
    from gt4py_tpu_torch.next.fbuiltins import exp, maximum, sqrt

    @gtx.field_operator
    def softplusish(a, b):
        return sqrt(maximum(a, b)) + exp(-a)

    av, bv = rng.random(5) + 0.5, rng.random(5) + 0.5
    out = gtx.zeros({I: 5}, device="cpu")
    softplusish(gtx.as_field([I], av, device="cpu"), gtx.as_field([I], bv, device="cpu"), out=out)
    np.testing.assert_allclose(
        out.asnumpy(), np.sqrt(np.maximum(av, bv)) + np.exp(-av), rtol=1e-12
    )


@pytest.mark.parametrize("backend", [None, "torch", "numpy"])
def test_backend_triangulation(backend, rng):
    """Same operator across eager / jit / numpy-oracle backends."""

    @gtx.field_operator
    def mix(a, b):
        return where(a > 0.5, a - b, a + b)

    av, bv = rng.random(12), rng.random(12)
    out = gtx.zeros({I: 12}, device="cpu")
    mix.with_backend(backend)(
        gtx.as_field([I], av, device="cpu"), gtx.as_field([I], bv, device="cpu"), out=out
    )
    np.testing.assert_allclose(
        out.asnumpy(), np.where(av > 0.5, av - bv, av + bv)
    )


def test_multi_offset_premap_folds(rng):
    """field(off1, off2) == field(off1)(off2) (reference __call__ fold)."""

    @gtx.field_operator
    def two_shifts(a):
        return a(Ioff[1], Ioff[1]) - 2.0 * a(Ioff[1]) + a

    av = rng.random(10)
    out = gtx.zeros({I: (0, 8)}, device="cpu")
    two_shifts(gtx.as_field([I], av, device="cpu"), out=out, offset_provider=PROV)
    np.testing.assert_allclose(out.asnumpy(), av[2:] - 2 * av[1:-1] + av[:-2], atol=1e-12)


def test_program_with_scan_and_domain(rng):
    """Whole-program jit covers scans and domain-restricted writes."""

    @gtx.scan_operator(axis=K, forward=True, init=0.0)
    def cumsum(c, x):
        return c + x

    @gtx.field_operator
    def half(a):
        return 0.5 * a

    @gtx.program
    def prog(x, tmp, out):
        cumsum(x, out=tmp)
        half(tmp, out=out, domain={K: (1, 5)})

    xv = rng.random(6)
    x = gtx.as_field([K], xv, device="cpu")
    tmp = gtx.zeros({K: 6}, device="cpu")
    out = gtx.zeros({K: 6}, device="cpu")
    prog(x, tmp, out)
    cs = np.cumsum(xv)
    expected = np.zeros(6)
    expected[1:5] = 0.5 * cs[1:5]
    np.testing.assert_allclose(tmp.asnumpy(), cs)
    np.testing.assert_allclose(out.asnumpy(), expected)
    # repeat: cached executable, same results
    prog(x, tmp, out)
    np.testing.assert_allclose(out.asnumpy(), expected)


def test_program_scalar_kwargs(rng):
    @gtx.field_operator
    def scale(a, s: float):
        return a * s

    @gtx.program
    def prog(a, out, s: float):
        scale(a, s=s, out=out)

    av = rng.random(5)
    out = gtx.zeros({I: 5}, device="cpu")
    prog(gtx.as_field([I], av, device="cpu"), out, s=3.0)
    np.testing.assert_allclose(out.asnumpy(), av * 3.0)
    prog(gtx.as_field([I], av, device="cpu"), out, s=7.0)
    np.testing.assert_allclose(out.asnumpy(), av * 7.0)


def test_program_jit_inlines_oracle_backend_operators(rng):
    """Operators with backend="numpy" inside a jitted program inline into
    the trace (the enclosing jit owns execution)."""

    @gtx.field_operator(backend="numpy")
    def dbl_oracle(a):
        return a * 2.0

    @gtx.program
    def prog(a, out):
        dbl_oracle(a, out=out)

    av = rng.random(5)
    out = gtx.zeros({I: 5}, device="cpu")
    prog(gtx.as_field([I], av, device="cpu"), out)
    np.testing.assert_allclose(out.asnumpy(), 2 * av)


# --- closure variables (reference closure_var_folding semantics) -------------

_CLOSURE_GAIN = 3.0


@gtx.field_operator
def _gain_op(a):
    return a * _CLOSURE_GAIN


def test_closure_vars_snapshot_at_first_compile(rng):
    """Closure/module constants are compile-time constants (reference
    foast closure_var_folding): the first compiled variant pins the value;
    later rebinding the module global does NOT change compiled results."""
    a = gtx.as_field([I], np.ones(6), device="cpu")
    out = gtx.zeros({I: 6}, device="cpu")
    _gain_op(a, out=out)
    np.testing.assert_allclose(np.asarray(out.ndarray), 3.0)

    import tests.test_torch_execution_breadth as mod

    old = mod._CLOSURE_GAIN
    try:
        mod._CLOSURE_GAIN = 7.0
        _gain_op(a, out=out)
        # same variant key -> the pinned constant, like the reference
        np.testing.assert_allclose(np.asarray(out.ndarray), 3.0)
    finally:
        mod._CLOSURE_GAIN = old


def test_closure_var_kinds(rng):
    """int / float / np scalar / bool closure constants all fold."""
    gain_i = 2
    gain_f = 0.5
    gain_np = np.float64(4.0)
    flag = True

    @gtx.field_operator
    def op(a):
        base = a * gain_i + a * gain_f + a * gain_np
        return where(a > -1.0, base, base) if flag else base

    data = rng.random(5)
    out = gtx.zeros({I: 5}, device="cpu")
    op(gtx.as_field([I], data, device="cpu"), out=out)
    np.testing.assert_allclose(np.asarray(out.ndarray), data * 6.5, rtol=1e-12)
