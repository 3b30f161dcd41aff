"""The port's field-view frontend (gt4py_tpu_torch.next) against the JAX
package's (gt4py_tpu.next).

The same inputs, made from a seed with NumPy, go through both packages:
on the JAX side through ``jax`` (embedded) and ``tpu:pallas`` (the bridge,
Pallas in interpret mode off the TPU), on the port's through ``torch``
(embedded) and ``cuda:hopper`` (the bridge; on CPU tensors the kernels'
plain version). Every written point is compared.

Tolerances: rtol 1e-12 in float64 and 1e-5 in float32 (atol 0) — the two
packages compute the same operations in the same types, and the float32
bound leaves room for one rounding per operation of vadv's and tridiag's
recurrences over their levels.

Tests marked ``cuda`` run the bridged operators on a card and skip without
one. The JAX package is imported inside the tests that compare with it
(:func:`_ref`), so the file imports where JAX is absent (the card's
machine).
"""

import functools
import inspect
import types

import numpy as np
import pytest
import torch

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.core.definitions import WEAK_FLOAT, WEAK_INT, bfloat16, promote_types
from gt4py_tpu_torch.next import field_utils

from . import torch_next_defs as defs

RTOL = {np.float32: 1e-5, np.float64: 1e-12}
STRUCTURED = ("lap", "hdiff_op", "solve_tridiag", "next_vadv")
SIZES = ((12, 12, 4), (7, 6, 9))
FUSE_ENV = "GT4PY_CUDA_FUSE_STAGES"


@functools.lru_cache(maxsize=None)
def _ref() -> types.SimpleNamespace:
    """The JAX package's field-view module and its twins of the port's
    operators (tests/next_tests/test_cartesian_bridge.py holds the
    structured ones; the rest are defined here as torch_next_defs defines
    them)."""
    import gt4py_tpu.next as rgtx
    from gt4py_tpu.next import (
        astype,
        broadcast,
        concat_where,
        max_over,
        min_over,
        neighbor_sum,
        where,
    )
    from tests.next_tests import cases
    from tests.next_tests import test_cartesian_bridge as rb

    IDim, JDim, KDim, Koff = rb.IDim, rb.JDim, rb.KDim, rb.Koff
    V2E, E2V, V2EDim = cases.V2E, cases.E2V, cases.V2EDim

    @rgtx.scan_operator(axis=KDim, forward=True, init=0.0)
    def weighted_cumsum(carry: float, a: float, w: float) -> float:
        return carry * w + a

    @rgtx.field_operator
    def sum_and_diff(a, b):
        return a + b, a - b

    @rgtx.field_operator
    def select_and_cast(a, m):
        c = where(a > 0.5, a, 0.0)
        return c + astype(m, rgtx.float32) * a + broadcast(2.0, (IDim, JDim, KDim)) * a + m * 0.5

    @rgtx.field_operator
    def k_boundary(a):
        return concat_where(KDim == 0, a, a(Koff[-1]) * 0.5)

    @rgtx.field_operator
    def edge_sum(e):
        return neighbor_sum(e(V2E), axis=V2EDim)

    @rgtx.field_operator
    def edge_spread(e):
        return max_over(e(V2E), axis=V2EDim) - min_over(e(V2E), axis=V2EDim)

    @rgtx.field_operator
    def vertex_jump(v):
        return v(E2V[1]) - v(E2V[0])

    lap = rb.lap
    ops = dict(
        lap=lap, hdiff_op=rb.hdiff_op, solve_tridiag=rb.solve_tridiag,
        next_vadv=rb.next_vadv, weighted_cumsum=weighted_cumsum,
        sum_and_diff=sum_and_diff, select_and_cast=select_and_cast,
        k_boundary=k_boundary, edge_sum=edge_sum, edge_spread=edge_spread,
        vertex_jump=vertex_jump,
    )
    dims = {d.value: d for d in (IDim, JDim, KDim, cases.Vertex, cases.Edge,
                                 cases.V2EDim, cases.E2VDim)}
    return types.SimpleNamespace(gtx=rgtx, ops=ops, dims=dims, cases=cases,
                                 prov_k=rb.PROV_K, rb=rb)


def _to_ref(value):
    """A port Field (or scalar) as the JAX package's, same data and domain."""
    if not isinstance(value, gtx.Field):
        return value
    ref = _ref()
    dom = ref.gtx.domain({
        ref.dims[nr.dim.value]: (nr.unit_range.start, nr.unit_range.stop)
        for nr in value.domain.ranges
    })
    return ref.gtx.as_field(dom, value.asnumpy())


def _ref_out(out):
    if isinstance(out, tuple):
        return tuple(_ref_out(o) for o in out)
    ref = _ref()
    dom = ref.gtx.domain({
        ref.dims[nr.dim.value]: (nr.unit_range.start, nr.unit_range.stop)
        for nr in out.domain.ranges
    })
    return ref.gtx.zeros(dom, out.dtype)


def _bridged_variant(op):
    variants = [v for v in op.__dict__.get("_bridge_cache", {}).values() if v is not None]
    assert variants, "the bridge did not serve the operator"
    return variants[0]


def _port_run(op, backend, args, kwargs, out, provider):
    op = op.with_backend(backend)
    op(*args, out=out, offset_provider=provider, **kwargs)
    return op


def _assert_close(got, want, dtype):
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype], atol=0)


# --- promotion ----------------------------------------------------------------------

_TYPES = [np.dtype(t) for t in ("bool", "int8", "int16", "int32", "int64", "uint8",
                                "uint16", "uint32", "uint64", "float16", "float32",
                                "float64")] + [bfloat16, WEAK_INT, WEAK_FLOAT]


def _jax_operand(t):
    import jax.numpy as jnp

    if t == WEAK_INT:
        return 1
    if t == WEAK_FLOAT:
        return 1.0
    return jnp.ones(2, jnp.bfloat16 if t == bfloat16 else t)


@pytest.mark.parametrize("first", _TYPES, ids=str)
def test_promotion_lattice_matches_jax(first):
    """``promote_types`` is JAX's lattice with 64-bit types on, as the JAX
    package runs it: for ``first`` against every type, the result type and
    whether it is weak."""
    _ref()  # imports the JAX package, which turns 64-bit types on
    import jax.numpy as jnp

    for second in _TYPES:
        r = jnp.add(_jax_operand(first), _jax_operand(second))
        want = "bfloat16" if r.dtype == jnp.bfloat16 else np.dtype(r.dtype).name
        got, weak = promote_types(first, second)
        assert ("bfloat16" if got == bfloat16 else got.name, weak) == (want, bool(r.weak_type)), (
            first, second)


# --- the structured operators -------------------------------------------------------


@pytest.mark.parametrize("size", SIZES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=lambda d: d.__name__)
@pytest.mark.parametrize("name", STRUCTURED)
def test_structured_operator_matches_reference(name, dtype, size):
    """The port's ``torch`` and ``cuda:hopper`` (bridged, plain version on
    CPU tensors) against the JAX package's ``jax`` and ``tpu:pallas``; the
    port's bridge serves the operator with the kernel the table names."""
    ref = _ref()
    op = getattr(defs, name)
    args, kwargs, out_t = defs.inputs(name, *size, dtype, seed=5, device="cpu")
    _, _, out_h = defs.inputs(name, *size, dtype, seed=5, device="cpu")
    _port_run(op, "torch", args, kwargs, out_t, defs.PROV_K)
    hop = _port_run(op, "cuda:hopper", args, kwargs, out_h, defs.PROV_K)
    variant = _bridged_variant(hop)
    assert variant.backend.strategy == defs.KERNEL[name][0]
    assert variant.backend.last_strategy == "plain"

    ref_args = tuple(_to_ref(a) for a in args)
    for backend, got in (("jax", out_t), ("tpu:pallas", out_h)):
        ref_out = _ref_out(out_t)
        ref.ops[name].with_backend(backend)(*ref_args, out=ref_out, offset_provider=ref.prov_k)
        assert got.dtype == np.dtype(dtype)
        _assert_close(got.asnumpy(), ref_out.asnumpy(), dtype)


@pytest.mark.parametrize("name", ["solve_tridiag", "next_vadv"])
def test_column_operators_with_the_fusion_switch(name, monkeypatch):
    """With the stage-fusion switch on, the two scans of solve_tridiag build
    into one ``fused_column`` kernel (K4's class); next_vadv, whose K index
    field is lower-dimensional, stays on ``column``, as the JAX package's
    K4 refuses it (pallas_seq.py:314-320). The result is unchanged."""
    monkeypatch.setenv(FUSE_ENV, "1")
    args, kwargs, out = defs.inputs(name, 7, 6, 9, np.float64, seed=6, device="cpu")
    _, _, plain = defs.inputs(name, 7, 6, 9, np.float64, seed=6, device="cpu")
    hop = _port_run(getattr(defs, name), "cuda:hopper", args, kwargs, out, defs.PROV_K)
    assert _bridged_variant(hop).backend.strategy == defs.KERNEL[name][1]
    _port_run(getattr(defs, name), "torch", args, kwargs, plain, defs.PROV_K)
    _assert_close(out.asnumpy(), plain.asnumpy(), np.float64)


@pytest.mark.parametrize("backend", ["torch", "cuda:hopper"])
def test_scan_operator_matches_reference(backend):
    """A scan on its own, with a scalar argument: the port's embedded level
    loop and its bridge (onto ``column``) against the JAX package's."""
    ref = _ref()
    rng = np.random.default_rng(8)
    a = gtx.as_field([defs.IDim, defs.JDim, defs.KDim], rng.random((5, 4, 7)), device="cpu")
    out = gtx.zeros({defs.IDim: 5, defs.JDim: 4, defs.KDim: 7}, device="cpu")
    op = defs.weighted_cumsum.with_backend(backend)
    op(a, 0.5, out=out)
    if backend == "cuda:hopper":
        assert _bridged_variant(op).backend.strategy == "column"
    ref_out = _ref_out(out)
    ref.ops["weighted_cumsum"](_to_ref(a), 0.5, out=ref_out)
    _assert_close(out.asnumpy(), ref_out.asnumpy(), np.float64)


@pytest.mark.parametrize("program", ["lap_twice", "lap_twice_hopper"])
def test_program_calling_two_operators(program):
    """A ``@program`` whose two operator calls chain through a field
    between them, on each backend, against the JAX package's ``lap``
    applied twice."""
    ref = _ref()
    rng = np.random.default_rng(9)
    phi = gtx.as_field([defs.IDim, defs.JDim, defs.KDim], rng.random((10, 9, 3)), device="cpu")
    tmp = gtx.zeros({defs.IDim: (1, 9), defs.JDim: (1, 8), defs.KDim: 3}, device="cpu")
    out = gtx.zeros({defs.IDim: (2, 8), defs.JDim: (2, 7), defs.KDim: 3}, device="cpu")
    getattr(defs, program)(phi, tmp, out, offset_provider=defs.PROV)
    if program == "lap_twice_hopper":
        assert _bridged_variant(defs.lap_hopper).backend.strategy == "plane"
    ref_tmp, ref_out = _ref_out(tmp), _ref_out(out)
    ref.ops["lap"](_to_ref(phi), out=ref_tmp, offset_provider=ref.prov_k)
    ref.ops["lap"](ref_tmp, out=ref_out, offset_provider=ref.prov_k)
    _assert_close(tmp.asnumpy(), ref_tmp.asnumpy(), np.float64)
    _assert_close(out.asnumpy(), ref_out.asnumpy(), np.float64)


@pytest.mark.parametrize("backend", ["torch", "cuda:hopper"])
def test_tuple_return(backend):
    """A tuple return writes both out fields; the bridge takes single
    results only, so ``cuda:hopper`` runs it embedded."""
    ref = _ref()
    rng = np.random.default_rng(10)
    a, b = (gtx.as_field([defs.IDim, defs.KDim], rng.random((6, 5)), device="cpu")
            for _ in range(2))
    outs = tuple(gtx.zeros({defs.IDim: 6, defs.KDim: 5}, device="cpu") for _ in range(2))
    op = defs.sum_and_diff.with_backend(backend)
    op(a, b, out=outs)
    assert not any(op.__dict__.get("_bridge_cache", {}).values())
    ref_outs = _ref_out(outs)
    ref.ops["sum_and_diff"](_to_ref(a), _to_ref(b), out=ref_outs)
    for got, want in zip(outs, ref_outs):
        _assert_close(got.asnumpy(), want.asnumpy(), np.float64)


@pytest.mark.parametrize("backend", ["torch", "cuda:hopper"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=lambda d: d.__name__)
def test_where_astype_broadcast_promote_as_the_reference(dtype, backend):
    """``where`` with a weak literal, ``astype``, ``broadcast`` of a Python
    scalar and an int32 field promote as the JAX package's do: the result
    type and every value."""
    ref = _ref()
    rng = np.random.default_rng(11)
    a = gtx.as_field([defs.IDim, defs.JDim, defs.KDim], rng.random((5, 4, 3)).astype(dtype),
                     device="cpu")
    m = gtx.as_field([defs.IDim, defs.JDim, defs.KDim],
                     rng.integers(0, 5, (5, 4, 3)).astype(np.int32), device="cpu")
    result = defs.select_and_cast.with_backend(backend).definition(a, m)
    ref_result = ref.ops["select_and_cast"].definition(_to_ref(a), _to_ref(m))
    assert result.dtype == np.dtype(ref_result.dtype)
    out = gtx.zeros({defs.IDim: 5, defs.JDim: 4, defs.KDim: 3}, result.dtype, device="cpu")
    defs.select_and_cast.with_backend(backend)(a, m, out=out)
    ref_out = _ref_out(out)
    ref.ops["select_and_cast"](_to_ref(a), _to_ref(m), out=ref_out)
    _assert_close(out.asnumpy(), ref_out.asnumpy(), result.dtype.type)


@pytest.mark.parametrize("backend", ["torch", "cuda:hopper"])
def test_concat_where_on_the_vertical(backend):
    """``concat_where(KDim == 0, ...)``: embedded, and bridged as K sections
    of one stencil, which reads a K offset: ``column``, as the JAX package's
    K3 (``staged``) serves it."""
    ref = _ref()
    rng = np.random.default_rng(12)
    a = gtx.as_field([defs.IDim, defs.JDim, defs.KDim], rng.random((4, 5, 6)), device="cpu")
    out = gtx.zeros({defs.IDim: 4, defs.JDim: 5, defs.KDim: 6}, device="cpu")
    op = defs.k_boundary.with_backend(backend)
    op(a, out=out, offset_provider=defs.PROV_K)
    if backend == "cuda:hopper":
        assert _bridged_variant(op).backend.strategy == "column"
    ref_out = _ref_out(out)
    ref.ops["k_boundary"](_to_ref(a), out=ref_out, offset_provider=ref.prov_k)
    _assert_close(out.asnumpy(), ref_out.asnumpy(), np.float64)


# --- unstructured ---------------------------------------------------------------------


@pytest.mark.parametrize("skips", [False, True], ids=["full", "skip_value"])
@pytest.mark.parametrize("name", ["edge_sum", "edge_spread", "vertex_jump"])
def test_unstructured_matches_reference(name, skips):
    """Remaps through the toy mesh's connectivities (one gather, missing
    neighbours masked) and neighbour reductions, on ``torch`` and on
    ``cuda:hopper`` (which runs them embedded), against the JAX package's.
    A reduction skips missing neighbours; a partial shift's value at a
    missing neighbour is undefined (the JAX package's TPU gathers fill
    another value there than its NumPy oracle), so ``vertex_jump`` is
    compared where both neighbours exist."""
    ref = _ref()
    e2v, v2e = defs.toy_mesh_tables()
    np.testing.assert_array_equal(e2v, ref.cases.TOY_E2V_TABLE)
    np.testing.assert_array_equal(v2e, ref.cases.TOY_V2E_TABLE)
    skip = -1 if skips else None
    if skips:
        e2v, v2e = defs.with_skips(e2v, 4), defs.with_skips(v2e)
    prov = {
        "E2V": field_utils.connectivity_from_numpy(
            e2v, [defs.Edge, defs.E2VDim], defs.Vertex, skip_value=skip, device="cpu"),
        "V2E": field_utils.connectivity_from_numpy(
            v2e, [defs.Vertex, defs.V2EDim], defs.Edge, skip_value=skip, device="cpu"),
    }
    ref_prov = {
        "E2V": ref.gtx.as_connectivity([ref.cases.Edge, ref.cases.E2VDim], ref.cases.Vertex,
                                       e2v, skip_value=skip),
        "V2E": ref.gtx.as_connectivity([ref.cases.Vertex, ref.cases.V2EDim], ref.cases.Edge,
                                       v2e, skip_value=skip),
    }
    rng = np.random.default_rng(13)
    src_dim, dst_dim = (defs.Vertex, defs.Edge) if name == "vertex_jump" else (defs.Edge, defs.Vertex)
    n_src = {defs.Vertex: 9, defs.Edge: 18}
    x = gtx.as_field([src_dim], rng.random(n_src[src_dim]), device="cpu")
    for backend in ("torch", "cuda:hopper"):
        out = gtx.zeros({dst_dim: n_src[dst_dim]}, device="cpu")
        op = getattr(defs, name).with_backend(backend)
        op(x, out=out, offset_provider=prov)
        assert not any(op.__dict__.get("_bridge_cache", {}).values())
        ref_out = _ref_out(out)
        ref.ops[name](_to_ref(x), out=ref_out, offset_provider=ref_prov)
        defined = (e2v != -1).all(axis=1) if name == "vertex_jump" else slice(None)
        _assert_close(out.asnumpy()[defined], ref_out.asnumpy()[defined], np.float64)


def test_dynamic_shift_as_offset_matches_reference():
    """``field(as_offset(Koff, idx))``: a per-point K shift, clamped at the
    field's ends, as in the JAX package."""
    ref = _ref()
    rng = np.random.default_rng(14)
    data = rng.random((4, 6))
    shift = rng.integers(-2, 3, (4, 6)).astype(np.int32)
    dims = [defs.IDim, defs.KDim]
    got = gtx.as_field(dims, data, device="cpu")(
        gtx.as_offset(defs.Koff, gtx.as_field(dims, shift, device="cpu")))
    rdims = [ref.dims["IDim"], ref.dims["KDim"]]
    want = ref.gtx.as_field(rdims, data)(
        ref.gtx.as_offset(ref.rb.Koff, ref.gtx.as_field(rdims, shift)))
    _assert_close(got.asnumpy(), want.asnumpy(), np.float64)


# --- layout, writes in place, state carried across ------------------------------------


def test_constructed_fields_are_k_leading_and_results_stay_so():
    """A field over (I, J, K) is a (K, I, J) buffer with J contiguous, seen
    in (I, J, K) order, so the kernels' J-walking threads read neighbouring
    addresses; embedded elementwise results keep that layout."""
    args, _, out = defs.hdiff_inputs(6, 5, 3, 2, np.float64, seed=1, device="cpu")
    inp = args[0]
    assert inp.shape == (10, 9, 3)
    assert inp.ndarray.stride() == (9, 1, 90)
    assert out.ndarray.stride() == (5, 1, 30)
    shifted = inp(defs.Ioff[1]) * 2.0 + inp
    assert shifted.ndarray.stride()[1] == 1
    assert shifted.ndarray.stride()[2] == max(shifted.ndarray.stride())
    i_k = gtx.zeros({defs.IDim: 3, defs.KDim: 4}, device="cpu")
    assert i_k.ndarray.stride() == (1, 3)
    k_i = gtx.zeros({defs.KDim: 4, defs.IDim: 3}, device="cpu")
    assert k_i.ndarray.stride() == (3, 1)


def test_constructors_default_to_the_card():
    """Every constructor puts its buffer on the card unless told otherwise;
    with no card it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    dom = {defs.IDim: 2, defs.KDim: 2}
    for make in (
        lambda: gtx.zeros(dom), lambda: gtx.ones(dom), lambda: gtx.full(dom, 1.0),
        lambda: gtx.empty(dom), lambda: gtx.as_field([defs.IDim], np.ones(3)),
        lambda: gtx.as_connectivity([defs.Edge, defs.E2VDim], defs.Vertex, np.zeros((2, 2))),
    ):
        with pytest.raises((AssertionError, RuntimeError)):
            make()
    assert gtx.zeros(dom, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("backend", ["torch", "cuda:hopper"])
def test_out_field_that_is_also_an_input(backend):
    """``lap(phi, out=phi[1:-1, 1:-1])``: the out field is a view of the
    input. Every point is computed from the values before the call, as the
    JAX package (whose arrays are values) computes it."""
    ref = _ref()
    data = np.random.default_rng(15).random((8, 7, 2))
    phi = gtx.as_field([defs.IDim, defs.JDim, defs.KDim], data, device="cpu")
    op = defs.lap.with_backend(backend)
    op(phi, out=phi[1:-1, 1:-1], offset_provider=defs.PROV)
    if backend == "cuda:hopper":
        _bridged_variant(op)
    rphi = _to_ref(gtx.as_field([defs.IDim, defs.JDim, defs.KDim], data, device="cpu"))
    ref_out = ref.gtx.zeros(rphi.domain)
    ref.ops["lap"](rphi, out=ref_out[1:-1, 1:-1], offset_provider=ref.prov_k)
    want = data.copy()
    want[1:-1, 1:-1] = ref_out.asnumpy()[1:-1, 1:-1]
    _assert_close(phi.asnumpy(), want, np.float64)


def test_bridge_hands_views_not_copies(monkeypatch):
    """The bridge hands the kernels the fields' own tensors (views), so the
    out field is written in place."""
    args, kwargs, out = defs.inputs("hdiff_op", 6, 5, 3, np.float64, seed=2, device="cpu")
    op = defs.hdiff_op.with_backend("cuda:hopper")
    op(*args, out=out, offset_provider=defs.PROV)
    variant = _bridged_variant(op)
    seen = {}
    real = variant.backend.run
    monkeypatch.setattr(variant.backend, "run",
                        lambda arrays, *a: seen.update(arrays) or real(arrays, *a))
    op(*args, out=out, offset_provider=defs.PROV)
    assert seen[variant.out_name].data_ptr() == out.ndarray.data_ptr()
    assert seen["inp"].data_ptr() == args[0].ndarray.data_ptr()
    assert seen["coeff"].data_ptr() == args[1].ndarray.data_ptr()


@pytest.mark.parametrize("name", STRUCTURED)
def test_bridged_gtir_round_trips_through_text(name):
    """The GTIR the bridge lowers an operator to, printed and parsed again
    (``gtir_transform``, the test point of
    tests/next_tests/test_bridge_gtir_roundtrip.py), builds the same kernel
    and computes the same result, and prints as the JAX package's bridge
    prints its GTIR for the same operator."""
    from gt4py_tpu.cartesian import gtir_pretty as ref_pretty
    from gt4py_tpu.next import cartesian_bridge as ref_bridge
    from gt4py_tpu.next.foast import exec_definition as ref_exec

    from gt4py_tpu_torch.cartesian import gtir_pretty
    from gt4py_tpu_torch.next import cartesian_bridge
    from gt4py_tpu_torch.next.foast import exec_definition

    ref = _ref()
    texts = []

    def round_trip(stencil):
        texts.append(gtir_pretty.pretty(stencil))
        return gtir_pretty.parse(texts[-1])

    args, kwargs, out = defs.inputs(name, 6, 5, 4, np.float64, seed=4, device="cpu")
    _, _, direct = defs.inputs(name, 6, 5, 4, np.float64, seed=4, device="cpu")
    op = getattr(defs, name)
    hop = _port_run(op, "cuda:hopper", args, kwargs, direct, defs.PROV_K)
    names = list(inspect.signature(op.definition).parameters)
    bound = dict(zip(names, args))
    fields = {n: v for n, v in bound.items() if isinstance(v, gtx.Field)}
    scalars = {n: v for n, v in bound.items() if not isinstance(v, gtx.Field)}
    variant = cartesian_bridge.build_variant(
        exec_definition(op), fields, scalars, out, defs.PROV_K, "cuda:hopper",
        gtir_transform=round_trip,
    )
    cartesian_bridge.execute(variant, fields, scalars, out)
    assert variant.backend.strategy == _bridged_variant(hop).backend.strategy
    np.testing.assert_array_equal(out.asnumpy(), direct.asnumpy())

    ref_texts = []
    ref_fields = {n: _to_ref(v) for n, v in fields.items()}
    ref_bridge.build_variant(
        ref_exec(ref.ops[name]), ref_fields, scalars, _ref_out(out), ref.prov_k, "numpy",
        gtir_transform=lambda st: ref_texts.append(ref_pretty.pretty(st)) or st,
    )
    assert texts == ref_texts


def test_from_numpy_carries_jax_fields_across():
    """``field_utils.from_numpy`` turns a JAX package field, read out as
    NumPy with its dimension names and domain starts, into the port's."""
    ref = _ref()
    rdims = [ref.dims["IDim"], ref.dims["KDim"]]
    rf = ref.gtx.as_field(rdims, np.arange(12.0).reshape(3, 4), origin={rdims[0]: 1})
    f = field_utils.from_numpy(
        rf.asnumpy(), [(d.value, d.kind.value) for d in rf.dims],
        starts=[nr.unit_range.start for nr in rf.domain.ranges], device="cpu",
    )
    assert [(d.value, d.kind) for d in f.dims] == [("IDim", gtx.DimensionKind.HORIZONTAL),
                                                   ("KDim", gtx.DimensionKind.VERTICAL)]
    assert [(nr.unit_range.start, nr.unit_range.stop) for nr in f.domain.ranges] == [(-1, 2), (0, 4)]
    np.testing.assert_array_equal(f.asnumpy(), rf.asnumpy())
    assert f.ndarray.stride() == (1, 3)


# --- on the card ---------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [False, True], ids=["switch_off", "switch_on"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=lambda d: d.__name__)
@pytest.mark.parametrize("name", STRUCTURED)
def test_bridged_operator_on_card(name, dtype, fuse, monkeypatch):
    """Each bridged operator on the card through the kernel the table
    names, against the port's ``torch`` backend on the same card."""
    _need_card()
    monkeypatch.setenv(FUSE_ENV, "1" if fuse else "0")
    args, kwargs, out = defs.inputs(name, 37, 45, 11, dtype, seed=3)
    _, _, plain = defs.inputs(name, 37, 45, 11, dtype, seed=3)
    hop = _port_run(getattr(defs, name), "cuda:hopper", args, kwargs, out, defs.PROV_K)
    torch.cuda.synchronize()
    variant = _bridged_variant(hop)
    assert variant.backend.last_strategy == defs.KERNEL[name][int(fuse)]
    _port_run(getattr(defs, name), "torch", args, kwargs, plain, defs.PROV_K)
    assert out.device.type == "cuda" and out.ndarray.stride()[1] == 1
    _assert_close(out.asnumpy(), plain.asnumpy(), dtype)


@pytest.mark.cuda
def test_constructed_field_on_card_is_k_leading():
    _need_card()
    f = gtx.zeros({defs.IDim: 5, defs.JDim: 6, defs.KDim: 7}, np.float32)
    assert f.device.type == "cuda"
    assert f.ndarray.stride() == (6, 1, 30)
