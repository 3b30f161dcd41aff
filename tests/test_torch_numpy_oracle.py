"""The port's field-view ``numpy`` backend, the oracle of the field view,
against the JAX package's ``numpy`` backend (tests/next_tests/
test_numpy_oracle.py and test_field_arithmetic_matrix.py).

- The operator sees NumPy arrays, never tensors; shifts, remaps,
  reductions, builtins and scans run through NumPy, and the result lands
  in place in the caller's CPU tensor.
- Arithmetic promotes as NumPy 2 does, as the JAX package's ``numpy``
  applies NumPy's operators: every operator over pairs of dtypes and with
  Python and NumPy scalars gives the JAX package's ``numpy`` result to the
  bit, dtype included (and so differs from the ``torch`` backend, which
  keeps JAX's lattice, where NumPy and JAX differ).
- bfloat16 (no ``ml_dtypes`` on the card's machine) is carried in float32
  and rounded after every operation: equal to the JAX package's ``numpy``
  on ``ml_dtypes.bfloat16`` arrays to the bit.
- A Field on a card raises a TypeError naming its device: nothing is moved.

The JAX package is imported inside the tests.
"""

import operator

import numpy as np
import pytest
import torch

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.core.definitions import bfloat16
from gt4py_tpu_torch.next import Dimension, DimensionKind, FieldOffset, neighbor_sum, where

from . import torch_next_defs as ndefs

IDim = Dimension("IDim")
KDim = Dimension("KDim", kind=DimensionKind.VERTICAL)
Ioff = FieldOffset("Ioff", source=IDim, target=(IDim,))
Vertex = Dimension("Vertex")
Edge = Dimension("Edge")
V2EDim = Dimension("V2E", kind=DimensionKind.LOCAL)
V2E = FieldOffset("V2E", source=Edge, target=(Vertex, V2EDim))

_seen_types: list = []


@gtx.field_operator
def lap1d(inp):
    _seen_types.append(type(inp.ndarray))
    return inp(Ioff[1]) - 2.0 * inp + inp(Ioff[-1])


def _ref():
    import gt4py_tpu.next as rgtx

    return rgtx


def test_numpy_backend_runs_in_numpy():
    data = np.random.default_rng(0).random(18)
    f = gtx.as_field([IDim], data, device="cpu")
    out_np = gtx.zeros({IDim: (1, 17)}, device="cpu")
    out_t = gtx.zeros({IDim: (1, 17)}, device="cpu")
    _seen_types.clear()
    lap1d.with_backend("numpy")(f, out=out_np, offset_provider={"Ioff": IDim})
    assert _seen_types and all(t is np.ndarray for t in _seen_types)
    _seen_types.clear()
    lap1d(f, out=out_t, offset_provider={"Ioff": IDim})
    assert _seen_types and all(t is torch.Tensor for t in _seen_types)
    expect = data[2:] - 2.0 * data[1:-1] + data[:-2]
    np.testing.assert_array_equal(out_np.asnumpy(), expect)  # in place, NumPy's bits
    np.testing.assert_allclose(out_np.asnumpy(), out_t.asnumpy(), rtol=1e-12)


def test_numpy_backend_writes_a_view_of_the_out_tensor():
    f = gtx.as_field([IDim], np.arange(6.0), device="cpu")
    out = gtx.zeros({IDim: 6}, device="cpu")
    buffer = out.ndarray
    _double.with_backend("numpy")(f, out=out)
    assert out.ndarray is buffer
    np.testing.assert_array_equal(buffer.numpy(), np.arange(6.0) * 2.0)


@gtx.field_operator
def _double(a):
    return a * 2.0


def test_numpy_backend_refuses_a_field_off_the_host():
    """A tensor not on the host (here on the ``meta`` device, as one on a
    card) raises a TypeError naming its device; nothing is copied."""
    f = gtx.Field(gtx.domain({IDim: 4}), torch.empty(4, dtype=torch.float64, device="meta"))
    out = gtx.zeros({IDim: 4}, device="cpu")
    with pytest.raises(TypeError, match="meta"):
        _double.with_backend("numpy")(f, out=out)


@pytest.mark.cuda
def test_numpy_backend_refuses_a_card_field():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    f = gtx.as_field([IDim], np.ones(4))
    out = gtx.zeros({IDim: 4})
    with pytest.raises(TypeError, match="cuda"):
        _double.with_backend("numpy")(f, out=out)


# --- against the JAX package's numpy backend -----------------------------------------


def _oracle_pair(port_op, ref_op, arrays, out_domain, provider=None, ref_provider=None,
                 dims=(IDim,)):
    """(port result, JAX package result), both through ``numpy``, from the
    same arrays."""
    rgtx = _ref()
    rdims = tuple(rgtx.Dimension(d.value, kind=rgtx.DimensionKind(d.kind.value)) for d in dims)
    mine = [gtx.as_field(list(dims[: a.ndim]), a, device="cpu") for a in arrays]
    ref = [rgtx.as_field(list(rdims[: a.ndim]), a) for a in arrays]
    out = gtx.zeros(out_domain(dims), device="cpu")
    rout = rgtx.zeros(out_domain(rdims))
    port_op.with_backend("numpy")(*mine, out=out, offset_provider=provider or {})
    ref_op.with_backend("numpy")(*ref, out=rout, offset_provider=ref_provider or {})
    return out.asnumpy(), rout.asnumpy()


def test_where_and_builtins_match_reference():
    from gt4py_tpu_torch.next.fbuiltins import exp, sqrt

    rgtx = _ref()
    from gt4py_tpu.next.fbuiltins import exp as rexp, sqrt as rsqrt

    @gtx.field_operator
    def op(a, b):
        return where(a > b, sqrt(a), exp(b) * 0.5)

    @rgtx.field_operator
    def rop(a, b):
        return rgtx.where(a > b, rsqrt(a), rexp(b) * 0.5)

    rng = np.random.default_rng(1)
    a, b = rng.random(20) + 0.5, rng.random(20)
    mine, ref = _oracle_pair(op, rop, (a, b), lambda d: {d[0]: 20})
    np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(mine, np.where(a > b, np.sqrt(a), np.exp(b) * 0.5))


def test_unstructured_reduction_matches_reference():
    rgtx = _ref()
    rV, rE = rgtx.Dimension("Vertex"), rgtx.Dimension("Edge")
    rV2EDim = rgtx.Dimension("V2E", kind=rgtx.DimensionKind.LOCAL)
    rV2E = rgtx.FieldOffset("V2E", source=rE, target=(rV, rV2EDim))

    @gtx.field_operator
    def vsum(e):
        return neighbor_sum(e(V2E), axis=V2EDim)

    @rgtx.field_operator
    def rvsum(e):
        return rgtx.neighbor_sum(e(rV2E), axis=rV2EDim)

    rng = np.random.default_rng(2)
    table = rng.integers(0, 10, (6, 3))
    table[0, 1] = -1
    edges = rng.random(10)
    conn = gtx.as_connectivity([Vertex, V2EDim], Edge, table, skip_value=-1, device="cpu")
    rconn = rgtx.as_connectivity([rV, rV2EDim], rE, table, skip_value=-1)
    out = gtx.zeros({Vertex: 6}, device="cpu")
    rout = rgtx.zeros({rV: 6})
    vsum.with_backend("numpy")(gtx.as_field([Edge], edges, device="cpu"), out=out,
                               offset_provider={"V2E": conn})
    rvsum.with_backend("numpy")(rgtx.as_field([rE], edges), out=rout,
                                offset_provider={"V2E": rconn})
    np.testing.assert_array_equal(out.asnumpy(), rout.asnumpy())
    np.testing.assert_array_equal(
        out.asnumpy(), np.where(table == -1, 0.0, edges[table]).sum(axis=1))


@pytest.mark.parametrize("forward", [True, False], ids=["forward", "backward"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=lambda d: d.__name__)
def test_scan_matches_reference(forward, dtype):
    """The level loop in NumPy (the carry starts as ``init`` broadcast, a
    float64 array, as there), to the bit and in the out field's dtype."""
    rgtx = _ref()
    rK = rgtx.Dimension("KDim", kind=rgtx.DimensionKind.VERTICAL)
    rI = rgtx.Dimension("IDim")

    @gtx.scan_operator(axis=KDim, forward=forward, init=0.0, backend="numpy")
    def cumsum(carry, x):
        return carry * 0.5 + x

    @rgtx.scan_operator(axis=rK, forward=forward, init=0.0, backend="numpy")
    def rcumsum(carry, x):
        return carry * 0.5 + x

    data = np.random.default_rng(3).random((4, 7)).astype(dtype)
    out = gtx.zeros({IDim: 4, KDim: 7}, dtype, device="cpu")
    rout = rgtx.zeros({rI: 4, rK: 7}, dtype)
    cumsum(gtx.as_field([IDim, KDim], data, device="cpu"), out=out)
    rcumsum(rgtx.as_field([rI, rK], data), out=rout)
    assert out.asnumpy().dtype == rout.asnumpy().dtype == dtype
    np.testing.assert_array_equal(out.asnumpy(), rout.asnumpy())


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=lambda d: d.__name__)
@pytest.mark.parametrize("name", ["hdiff_op", "solve_tridiag", "next_vadv"])
def test_structured_operators_match_reference(name, dtype):
    """The chip's field-view main paths on ``numpy``, against the JAX
    package's ``numpy`` on the same inputs, to the bit."""
    from tests.next_tests import test_cartesian_bridge as rb

    from .test_torch_next import _ref_out, _to_ref

    args, kwargs, out = ndefs.inputs(name, 9, 8, 6, dtype, seed=4, device="cpu")
    getattr(ndefs, name).with_backend("numpy")(*args, out=out, offset_provider=ndefs.PROV_K,
                                               **kwargs)
    rout = _ref_out(out)
    getattr(rb, name).with_backend("numpy")(*(_to_ref(a) for a in args), out=rout,
                                            offset_provider=rb.PROV_K, **kwargs)
    np.testing.assert_array_equal(out.asnumpy(), rout.asnumpy())


# --- promotion: test_field_arithmetic_matrix.py's cases over dtypes --------------------

BINOPS = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "truediv": operator.truediv, "pow": operator.pow, "mod": operator.mod,
    "floordiv": operator.floordiv,
}
CMPS = {
    "lt": operator.lt, "le": operator.le, "gt": operator.gt,
    "ge": operator.ge, "eq": operator.eq, "ne": operator.ne,
}
DTYPES = ("int32", "int64", "float16", "float32", "float64")
SCALARS = {"int": 2, "float": 2.0, "np_float32": np.float32(2.0), "np_int64": np.int64(2)}


def _data(dtype: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype.startswith("int"):
        return rng.integers(1, 7, 6).astype(dtype)
    return (rng.random(6) + 0.5).astype(dtype)


def _pair(a: np.ndarray):
    """The same array as a port NumPy Field and a JAX package NumPy Field."""
    rgtx = _ref()
    return (gtx.Field(gtx.domain({IDim: (0, a.size)}), a.copy()),
            rgtx.Field(rgtx.domain({rgtx.Dimension("IDim"): (0, a.size)}), a.copy()))


def _same(mine, ref):
    got, want = np.asarray(mine.ndarray), np.asarray(ref.ndarray)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("right", DTYPES)
@pytest.mark.parametrize("left", DTYPES)
@pytest.mark.parametrize("name", sorted(BINOPS))
def test_field_field_binop_promotes_as_reference(name, left, right):
    op = BINOPS[name]
    (a, ra), (b, rb) = _pair(_data(left, 11)), _pair(_data(right, 12))
    with np.errstate(all="ignore"):
        _same(op(a, b), op(ra, rb))


@pytest.mark.parametrize("scalar", sorted(SCALARS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(BINOPS))
def test_field_scalar_and_reflected_promote_as_reference(name, dtype, scalar):
    op, s = BINOPS[name], SCALARS[scalar]
    a, ra = _pair(_data(dtype, 13))
    with np.errstate(all="ignore"):
        _same(op(a, s), op(ra, s))
        _same(op(s, a), op(s, ra))


@pytest.mark.parametrize("name", sorted(CMPS))
def test_field_comparisons_match_reference(name):
    op = CMPS[name]
    (a, ra), (b, rb) = _pair(_data("float64", 14)), _pair(_data("float32", 15))
    _same(op(a, b), op(ra, rb))


def test_unary_and_logical_ops_match_reference():
    a, ra = _pair(_data("float32", 16))
    _same(-a, -ra)
    _same(+a, +ra)
    _same(abs(a), abs(ra))
    (m, rm), (n, rn) = _pair(_data("float64", 17) > 1.0), _pair(_data("float64", 18) > 1.0)
    for op in (operator.and_, operator.or_, operator.xor):
        _same(op(m, n), op(rm, rn))
    _same(~m, ~rm)


def test_cross_dim_promotion_and_misaligned_ranges_match_reference():
    rgtx = _ref()
    J, rJ = Dimension("JDim"), rgtx.Dimension("JDim")
    rI = rgtx.Dimension("IDim")
    ai, bj = np.random.default_rng(19).random(4), np.random.default_rng(20).random(3)
    res = gtx.Field(gtx.domain({IDim: 4}), ai) + gtx.Field(gtx.domain({J: 3}), bj)
    rres = rgtx.Field(rgtx.domain({rI: 4}), ai) + rgtx.Field(rgtx.domain({rJ: 3}), bj)
    assert res.dims == (IDim, J)
    _same(res, rres)
    fa = gtx.Field(gtx.domain({IDim: (0, 6)}), _data("float64", 21))
    fb = gtx.Field(gtx.domain({IDim: (2, 8)}), _data("float32", 22))
    rfa = rgtx.Field(rgtx.domain({rI: (0, 6)}), _data("float64", 21))
    rfb = rgtx.Field(rgtx.domain({rI: (2, 8)}), _data("float32", 22))
    assert (fa + fb).domain[IDim].unit_range == gtx.UnitRange(2, 6)
    _same(fa + fb, rfa + rfb)


def test_numpy_and_torch_promote_differently_where_numpy_and_jax_do():
    """float32 × int64 is float64 on ``numpy`` (NumPy) and float32 on
    ``torch`` (JAX's lattice), as in the JAX package's two backends."""
    @gtx.field_operator
    def mul(a, b):
        return a * b

    a = gtx.as_field([IDim], np.ones(3, np.float32), device="cpu")
    b = gtx.as_field([IDim], np.full(3, 3, np.int64), device="cpu")
    assert mul.definition(gtx.Field(a.domain, a.asnumpy()), gtx.Field(b.domain, b.asnumpy())
                          ).dtype == np.float64
    assert mul.definition(a, b).dtype == np.float32


# --- bfloat16, carried in float32 ------------------------------------------------------


@gtx.field_operator
def _bf16_mix(a, b):
    return where(a > b, a * b + 0.1, (a - b) / 3.0) * 2.0


@gtx.field_operator
def _bf16_pure(a, b):
    return gtx.sin(a * b - a) / where(a > b, a, b) + a * a


@pytest.mark.parametrize("name", ["mix", "pure"])
def test_bfloat16_matches_reference_ml_dtypes(name):
    """bfloat16 fields on ``numpy``: an operation of bfloat16 operands is
    rounded to bfloat16, and one with a Python number computes in float32,
    as ml_dtypes promotes them; to the bit against the JAX package's
    ``numpy`` on ``ml_dtypes.bfloat16`` arrays, the result landing in the
    bfloat16 out tensor (rounded to nearest even, as ml_dtypes casts)."""
    import ml_dtypes

    rgtx = _ref()
    rI = rgtx.Dimension("IDim")

    @rgtx.field_operator
    def ref_mix(a, b):
        return rgtx.where(a > b, a * b + 0.1, (a - b) / 3.0) * 2.0

    @rgtx.field_operator
    def ref_pure(a, b):
        return rgtx.sin(a * b - a) / rgtx.where(a > b, a, b) + a * a

    op, ref_op = {"mix": (_bf16_mix, ref_mix), "pure": (_bf16_pure, ref_pure)}[name]
    rng = np.random.default_rng(23)
    a32, b32 = (rng.random(64) + 0.1).astype(np.float32), (rng.random(64) + 0.1).astype(np.float32)
    a = gtx.as_field([IDim], torch.from_numpy(a32).to(torch.bfloat16), device="cpu")
    b = gtx.as_field([IDim], torch.from_numpy(b32).to(torch.bfloat16), device="cpu")
    out = gtx.zeros({IDim: 64}, bfloat16, device="cpu")
    op.with_backend("numpy")(a, b, out=out)
    ra = rgtx.Field(rgtx.domain({rI: 64}), a32.astype(ml_dtypes.bfloat16))
    rb = rgtx.Field(rgtx.domain({rI: 64}), b32.astype(ml_dtypes.bfloat16))
    want = ref_op.definition(ra, rb).asnumpy()
    assert want.dtype == (np.float32 if name == "mix" else ml_dtypes.bfloat16)
    assert out.ndarray.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out.asnumpy(), want.astype(ml_dtypes.bfloat16).astype(np.float32))


# --- a fault of the vectorized evaluators, repaired ------------------------------------


@pytest.mark.parametrize("backend", ["numpy", "torch", "debug"])
def test_lower_dimensional_field_keeps_its_k_origin(backend):
    """A K-only field read by a stencil whose out starts one level up (the
    bridge's ``where(k_index > 0, inp(Koff[-1]), 2.0)`` over K in [1, nk))
    is read from its origin on: the vectorized evaluators dropped a
    lower-dimensional field's K origin, so level 1 read ``k_index[0]``."""
    from gt4py_tpu_torch.cartesian.backend.base import REGISTRY
    from gt4py_tpu_torch.next import cartesian_bridge as bridge
    from gt4py_tpu_torch.next.foast import exec_definition

    from . import torch_feature_defs as fdefs

    @gtx.field_operator
    def testee(inp: fdefs.IKField, k_index: gtx.Field[gtx.Dims[fdefs.KDim], np.int64]
               ) -> fdefs.IKField:
        return where(k_index > 0, inp(fdefs.Koff[-1]), 2.0)

    inp = gtx.as_field([fdefs.IDim, fdefs.KDim], np.arange(20.0).reshape(2, 10), device="cpu")
    kidx = gtx.as_field([fdefs.KDim], np.arange(10), device="cpu")
    out = gtx.zeros({fdefs.IDim: 2, fdefs.KDim: (1, 10)}, device="cpu")
    variant = bridge.build_variant(
        exec_definition(testee), {"inp": inp, "k_index": kidx}, {}, out,
        {"Koff": fdefs.KDim}, "cuda:hopper")
    variant.backend = REGISTRY[backend](variant.backend.analyzed, {})
    bridge.execute(variant, {"inp": inp, "k_index": kidx}, {}, out)
    np.testing.assert_array_equal(out.asnumpy(), np.arange(20.0).reshape(2, 10)[:, :9])
