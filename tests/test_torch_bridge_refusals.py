"""What the field-view bridge refuses, and what it lets through.

The bridge traces a field operator on symbolic values into cartesian GTIR.
A construct GTIR has no counterpart for — ``//``, ``^``, unary ``+``,
``not`` of a scalar parameter, a tuple handed to a scan, ``~`` or ``&`` of
integers (GTIR has them only as logical operators) — raises
``BridgeUnsupported`` in the trace, and the call then runs embedded. Each
such operator on ``cuda:hopper`` (CPU tensors here) equals the JAX
package's ``jax`` backend on the same inputs, exactly (integers and bools)
or within rtol 1e-12 (float64), and is remembered as refused. Any other
error of the trace or of the cartesian passes propagates: it is not taken
for a refusal.
"""

import functools

import numpy as np
import pytest

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.next import cartesian_bridge as bridge

NI, NK = 7, 5


def _define(pkg):
    """The operators, defined against ``pkg`` (``gt4py_tpu_torch.next`` or
    the JAX package's ``gt4py_tpu.next``)."""
    I = pkg.Dimension("I")
    K = pkg.Dimension("K", kind=pkg.DimensionKind.VERTICAL)
    F = pkg.Field[pkg.Dims[I, K], np.float64]
    N = pkg.Field[pkg.Dims[I, K], np.int32]
    B = pkg.Field[pkg.Dims[I, K], bool]

    @pkg.field_operator
    def floor_div(a: N) -> N:
        return a // 2

    @pkg.field_operator
    def bit_xor(p: B, q: B) -> B:
        return p ^ q

    @pkg.field_operator
    def unary_plus(x: F) -> F:
        return +x

    @pkg.field_operator
    def not_of_parameter(x: F, flag: bool) -> F:
        if not flag:
            r = x + 1.0
        else:
            r = x
        return r

    @pkg.scan_operator(axis=K, forward=True, init=0.0)
    def pair_sum(carry: float, pair: tuple[float, float]) -> float:
        return carry + pair[0] + pair[1]

    @pkg.field_operator
    def tuple_to_scan(x: F, y: F) -> F:
        return pair_sum((x, y))

    @pkg.field_operator
    def int_invert(a: N) -> N:
        return ~a

    @pkg.field_operator
    def int_and(a: N, b: N) -> N:
        return a & b

    @pkg.field_operator
    def negate(x: F) -> F:
        return -x

    return {
        "negate": (negate, ("x",), {}),
        "floor_div": (floor_div, ("a",), {}),
        "bit_xor": (bit_xor, ("p", "q"), {}),
        "unary_plus": (unary_plus, ("x",), {}),
        "not_of_parameter": (not_of_parameter, ("x",), {"flag": False}),
        "tuple_to_scan": (tuple_to_scan, ("x", "y"), {}),
        "int_invert": (int_invert, ("a",), {}),
        "int_and": (int_and, ("a", "b"), {}),
    }, (I, K)


@functools.lru_cache(maxsize=None)
def _reference():
    import gt4py_tpu.next as rgtx

    return rgtx, _define(rgtx)


def _inputs(seed=11) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "a": rng.integers(-9, 9, (NI, NK)).astype(np.int32),
        "b": rng.integers(-9, 9, (NI, NK)).astype(np.int32),
        "p": rng.random((NI, NK)) > 0.5,
        "q": rng.random((NI, NK)) > 0.5,
        "x": rng.random((NI, NK)),
        "y": rng.random((NI, NK)),
    }


def _run(pkg, ops, dims, name, backend, **field_kw):
    op, names, kwargs = ops[name]
    data = _inputs()
    fields = [pkg.as_field(list(dims), data[n], **field_kw) for n in names]
    out = pkg.as_field(list(dims), np.zeros_like(data[names[0]]), **field_kw)
    called = op.with_backend(backend)
    called(*fields, out=out, **kwargs)
    return np.asarray(out.asnumpy()), called


NAMES = ["floor_div", "bit_xor", "unary_plus", "not_of_parameter", "tuple_to_scan",
         "int_invert", "int_and"]


def _same_as_reference(name, got):
    rgtx, (rops, rdims) = _reference()
    want, _ = _run(rgtx, rops, rdims, name, "jax")
    assert got.dtype == want.dtype
    if got.dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_refused_construct_runs_embedded_as_the_reference(name):
    ops, dims = _define(gtx)
    bridge.calls_served.clear()
    got, op = _run(gtx, ops, dims, name, "cuda:hopper", device="cpu")
    assert not bridge.calls_served, f"{name} was bridged"
    assert list(op._bridge_cache.values()) == [None]
    _same_as_reference(name, got)


def test_bridgeable_operator_is_bridged():
    ops, dims = _define(gtx)
    bridge.calls_served.clear()
    got, op = _run(gtx, ops, dims, "negate", "cuda:hopper", device="cpu")
    assert sum(bridge.calls_served.values()) == 1
    assert all(v is not None for v in op._bridge_cache.values())
    _same_as_reference("negate", got)


@pytest.mark.parametrize("symbol", ["//", "^", "unary +"])
def test_symbolic_values_refuse_operators_without_gtir(symbol):
    tracer = bridge._Tracer({}, {}, np.float64)
    x = bridge.SymNode(tracer, "scalar", "x", ())
    apply = {"//": lambda: x // 2, "^": lambda: 1 ^ x, "unary +": lambda: +x}[symbol]
    with pytest.raises(bridge.BridgeUnsupported, match="has no GTIR counterpart"):
        apply()


def test_torch_function_of_a_symbolic_value_is_refused():
    import torch

    tracer = bridge._Tracer({}, {}, np.float64)
    with pytest.raises(bridge.BridgeUnsupported, match="logical_not"):
        torch.logical_not(bridge.SymNode(tracer, "scalar", "flag", ()))


@pytest.mark.parametrize("where", ["trace", "passes"])
def test_other_errors_of_the_bridge_propagate(where, monkeypatch):
    """A TypeError in the trace or in the cartesian passes is a fault, not
    a refusal: the call raises instead of running embedded."""
    from gt4py_tpu_torch.cartesian.passes import pipeline

    def broken(*args, **kwargs):
        raise TypeError("Unexpected expression: Broken")

    if where == "trace":
        monkeypatch.setattr(bridge.SymNode, "__neg__", broken)
    else:
        monkeypatch.setattr(pipeline, "analyze_gtir", broken)
    ops, dims = _define(gtx)
    with pytest.raises(TypeError, match="Unexpected expression"):
        _run(gtx, ops, dims, "negate", "cuda:hopper", device="cpu")


# --- staggered dimensions and half shifts (examples/shallow_water.py) -------------------


def _staggered(pkg, backend, cpu: dict):
    """shallow_water's ``update_h``, ``h - 0.02 * (u(I + 0.5) - u(I - 0.5))``,
    on ``backend`` from the same inputs; returns the out field's values."""
    I = pkg.Dimension("I")
    IHalf = pkg.flip_staggered(I)

    @pkg.field_operator
    def update_h(h: pkg.Field[pkg.Dims[I], np.float64],
                 u: pkg.Field[pkg.Dims[IHalf], np.float64]) -> pkg.Field[pkg.Dims[I], np.float64]:
        return h - 0.02 * (u(I + 0.5) - u(I - 0.5))

    n = 8
    h = pkg.as_field([I], np.linspace(1.0, 2.0, n), **cpu)
    u = pkg.as_field([IHalf], np.arange(n + 1.0) ** 2, **cpu)
    out = pkg.zeros({I: n}, **cpu)
    op = update_h.with_backend(backend)
    op(h, u, out=out)
    return out.asnumpy(), op


def test_staggered_operator_runs_embedded_as_the_reference():
    """A half shift moves between a dimension and its staggered twin,
    which the cartesian I/J/K cannot hold: the bridge refuses the call
    (the operator runs embedded) and equals the JAX package's ``jax``
    backend. The JAX package's ``tpu:pallas`` bridges it, mapping the two
    dimensions to two axes and reading each half shift as a whole one,
    and differs."""
    import gt4py_tpu.next as ref_gtx

    got, op = _staggered(gtx, "cuda:hopper", {"device": "cpu"})
    assert list(op._bridge_cache.values()) == [None]
    want, _ = _staggered(ref_gtx, "jax", {})
    np.testing.assert_allclose(got, want, rtol=1e-12)
    theirs, ref_op = _staggered(ref_gtx, "tpu:pallas", {})
    assert [v for v in ref_op._bridge_cache.values() if v is not None]
    assert not np.allclose(theirs, want)


def test_staggered_dimension_is_refused():
    with pytest.raises(bridge.BridgeUnsupported, match="staggered dimension"):
        bridge._dim_map({"u": gtx.zeros({gtx.flip_staggered(gtx.Dimension("I")): 3},
                                        device="cpu")})


def test_half_shift_of_an_untyped_operator_runs_embedded():
    """An operator without annotations skips type deduction: a half shift
    of a field over I (a premap onto its staggered twin, which the field
    lacks) reaches the trace, which refuses it, so the call runs embedded
    and raises there as on ``torch``, where a bridged call would have read
    the field at the whole shift."""
    I = gtx.Dimension("I")

    @gtx.field_operator
    def half(h):
        return h(I + 0.5)

    h = gtx.as_field([I], np.arange(6.0), device="cpu")
    for backend in ("torch", "cuda:hopper"):
        op = half.with_backend(backend)
        with pytest.raises(ValueError, match="no _StaggeredI dimension"):
            op(h, out=gtx.zeros({I: (0, 5)}, device="cpu"))
    assert list(op._bridge_cache.values()) == [None]
