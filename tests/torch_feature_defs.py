"""The field-view feature cases, written once for both packages.

Every test of the JAX package's tests/next_tests/test_feature_*.py (14
files, 126 tests) as a *case*: a function of a ``Case`` (backend, offset
provider, sizes) that defines its operators, allocates its inputs from the
kit's initializers (the same values on every backend and in both
packages), runs them, checks them against the test's own NumPy reference
through the kit's ``verify`` and returns what it wrote (a Field or a tree
of Fields), or raises where the test asserts an error.

The module is written against ``gt4py_tpu_torch.next`` and its kit
(tests/torch_cases.py), which is how chip_smoke.py and the port's tests
import it. A definition binds its package's own Dimension and operator
classes, so the JAX package's twin of every case is this same source
loaded a second time with ``PACKAGE = "gt4py_tpu"`` set before it runs
(:func:`load`): then ``gtx`` is ``gt4py_tpu.next`` and ``cases`` the JAX
package's kit, tests/next_tests/cases.py.

``CASES`` maps a case's name (the test's, with its parameters) to
``(group, grid, function, parameters)``; ``RAISES`` maps the cases whose
test asserts an error to the error's class name and the pattern its
message matches.
"""

import contextlib
import enum
import functools
import importlib.util
import os
import sys
from functools import reduce
from typing import NamedTuple

import numpy as np

PACKAGE = globals().get("PACKAGE", "gt4py_tpu_torch")

if PACKAGE == "gt4py_tpu_torch":
    import gt4py_tpu_torch.next as gtx
    from gt4py_tpu_torch.eve.utils import FrozenNamespace
    from gt4py_tpu_torch.next.experimental import as_offset

    from tests import torch_cases as cases

    zeros, ones, as_field = cases.zeros, cases.ones, cases.as_field

    def connectivity(domain_dims, codomain, table):
        return gtx.as_connectivity(domain_dims, codomain, table, device=cases.DEVICE)

else:  # the JAX package's twin (see :func:`load`)
    gtx = importlib.import_module(PACKAGE + ".next")
    FrozenNamespace = importlib.import_module(PACKAGE + ".eve.utils").FrozenNamespace
    as_offset = importlib.import_module(PACKAGE + ".next.experimental").as_offset
    cases = importlib.import_module("tests.next_tests.cases")
    zeros, ones, as_field = gtx.zeros, gtx.ones, gtx.as_field
    connectivity = gtx.as_connectivity

broadcast, where, astype = gtx.broadcast, gtx.where, gtx.astype
neighbor_sum, max_over, min_over = gtx.neighbor_sum, gtx.max_over, gtx.min_over
concat_where, minimum, named_collection = gtx.concat_where, gtx.minimum, gtx.named_collection

IDim, JDim, KDim = cases.IDim, cases.JDim, cases.KDim
Ioff, Koff = cases.Ioff, cases.Koff
Vertex, Edge = cases.Vertex, cases.Edge
V2E, E2V, V2EDim, E2VDim = cases.V2E, cases.E2V, cases.V2EDim, cases.E2VDim
IField, IJField, IJKField, IKField, KField = (
    cases.IField, cases.IJField, cases.IJKField, cases.IKField, cases.KField)
IBoolField, IIntField = cases.IBoolField, cases.IIntField
VField, EField = cases.VField, cases.EField
JField = gtx.Field[gtx.Dims[JDim], np.float64]
EmptyField = gtx.Field[(), np.float64]
V2E_TABLE, E2V_TABLE = cases.TOY_V2E_TABLE, cases.TOY_E2V_TABLE
RETURN = cases.RETURN

CASES: dict = {}
RAISES: dict = {}

#: the kernel each case's ``cuda:hopper`` calls are bridged onto
#: (``cartesian_bridge.calls_served``), or lowered onto for ``"neighbor"``
#: (``unstructured_codegen.calls_served``); every other case that raises
#: nothing runs embedded there
BRIDGED_ONTO = {
    "plane": (
        "cartesian_shift", "copy_through_tuple_unpack", "fold_shifts",
        "scalar_arg_with_field_and_shift", "tuples_of_scalars_fold",
    ),
    "fused_plane": (
        "arithmetic", "bit_ops[and]", "bit_ops[or]", "branch_local_temporaries[False]",
        "branch_local_temporaries[True]", "broadcast_two_fields", "compile_kwargs",
        "compile_then_call_uses_pool", "conditional", "conditional_compareop_mask",
        "conditional_scalar_promotion", "conditional_shifted",
        "constant_closure_vars_with_enums", "constant_closure_vars_with_frozen_namespace",
        "double_use_scalar", "else_branch_returns_if_falls_through[False]",
        "else_branch_returns_if_falls_through[True]", "identity_fo_execution",
        "if_both_branches_return[False]", "if_both_branches_return[True]",
        "if_branch_returns_else_falls_through[False]",
        "if_branch_returns_else_falls_through[True]", "if_two_names_then_ternary[False-False]",
        "if_two_names_then_ternary[False-True]", "if_two_names_then_ternary[True-False]",
        "if_two_names_then_ternary[True-True]", "implicit_broadcast_mixed_dim",
        "mod_negative_operands", "nested_if_stmt_conditional_return[False-False]",
        "nested_if_stmt_conditional_return[False-True]",
        "nested_if_stmt_conditional_return[True-False]",
        "nested_if_stmt_conditional_return[True-True]", "nested_tuple_return_through_call",
        "out_field_with_non_zero_domain_start", "power", "promotion_unstructured_k",
        "same_size_fields", "simple_if[False]", "simple_if[True]",
        "static_param_variants_compile_list", "ternary_operator[2-3]", "ternary_operator[3-2]",
        "unary_invert", "unary_neg", "zero_dims_fields",
    ),
    "column": (
        "compile_scan", "direct_scan_operator_call_embedded", "scan_with_named_tuple_carry",
        "solve_triag", "where_k_offset",
    ),
    "neighbor": (
        "compile_for_two_offset_providers", "composed_unstructured_shift", "nested_reduction",
        "reduction_with_common_expression", "tuple_return_unstructured",
        "tuple_with_local_field_in_reduction_shifted",
        # pointwise over one horizontal dimension, refused by the bridge
        "tuple_unpacking", "unary_pos",
    ),
}


#: the cases that raise nothing and whose ``torch`` run with card fields is not
#: served by CUDA graphs (each call made twice, :func:`second_calls`), with the
#: outcome (chip_smoke.py step 14, tests/test_torch_graph_jit.py):
#: ``"refused: <reasons>"`` (``otf.REFUSALS``) or ``"no graph call"``; every
#: other such case is in ``CAPTURED``
NOT_CAPTURED = {
    # constant folding raises ZeroDivisionError while the variant is built,
    # which the test accepts: no call reaches a capture
    "infinity_literal": "no graph call",
    "nan_literal": "no graph call",
}


@contextlib.contextmanager
def second_calls(otf):
    """Within the block, the first call of each CUDA-graph variant key
    (which runs eagerly) is made again at once, the contents of its
    tensors put back in between: the key's second call captures, and its
    replay is the call's result. So every graph call of a case is captured
    while each call has the effect of one."""
    trees: list = []
    graph_key, run = otf.graph_key, otf.GraphCache.run

    def keyed(tree, provider):
        trees[:] = [tree]
        return graph_key(tree, provider)

    def twice(cache, key, device, keeps, body):
        if (key, otf._stream(device).cuda_stream) in cache._graphs:
            return run(cache, key, device, keeps, body)
        tensors = _tensors(trees[0])
        saved = [t.clone() for t in tensors]
        run(cache, key, device, keeps, body)
        for t, s in zip(tensors, saved):
            t.copy_(s)
        return run(cache, key, device, keeps, body)

    otf.graph_key, otf.GraphCache.run = keyed, twice
    try:
        yield
    finally:
        otf.graph_key, otf.GraphCache.run = graph_key, run


def _tensors(tree) -> list:
    """The tensors of a call's arguments: each Field's data and mask, in
    tuples, lists, dicts and named collections too."""
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if hasattr(tree, "ndarray") and hasattr(tree, "domain"):  # a Field
        return [t for t in (tree.ndarray, tree.mask) if isinstance(t, torch.Tensor)]
    if isinstance(tree, dict):
        tree = tree.values()
    elif hasattr(type(tree), "__named_collection_fields__"):
        tree = [getattr(tree, n) for n in type(tree).__named_collection_fields__]
    elif not isinstance(tree, (tuple, list)):
        return []
    return [t for x in tree for t in _tensors(x)]


def graph_outcome(name: str) -> str:
    """Case ``name``'s pinned outcome on ``torch`` with card fields:
    ``"captured"`` (its calls served by graphs, none refused) or its entry
    in ``NOT_CAPTURED``."""
    return NOT_CAPTURED.get(name, "captured")


def bridged_kernels(name: str) -> set:
    """The kernels case ``name``'s ``cuda:hopper`` run is bridged or
    lowered onto (none: it runs embedded)."""
    return {kernel for kernel, names in BRIDGED_ONTO.items() if name in names}


def feature(group: str, grid: str = "cartesian", params=(None,), raises=None):
    """Register a case: one entry per parameter set."""

    def wrap(fn):
        for p in params:
            name = fn.__name__ if p is None else f"{fn.__name__}[{'-'.join(map(str, p))}]"
            CASES[name] = (group, grid, fn, p)
            if raises is not None:
                RAISES[name] = raises
        return fn

    return wrap


def make_case(grid: str, backend):
    return (cases.simple_cartesian_case if grid == "cartesian"
            else cases.simple_unstructured_case)(backend)


def run_case(name: str, backend):
    """Run case ``name`` on ``backend``: what it wrote."""
    group, grid, fn, params = CASES[name]
    case = make_case(grid, backend)
    return fn(case) if params is None else fn(case, *params)


def load(package: str):
    """This module loaded against ``package`` (``"gt4py_tpu"``: the JAX
    package's twins), under a module name of its own."""
    name = f"{__name__}__{package}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, os.path.abspath(__file__))
    module = importlib.util.module_from_spec(spec)
    module.PACKAGE = package
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def vdd(case, op, ref, comparison=None):
    """The kit's ``verify_with_default_data``, returning the out field(s)."""
    types = cases.get_param_types(op)
    shared = cases.UniqueInitializer()
    inps = tuple(
        cases._alloc_from_spec(spec, case, shared) for n, spec in types.items() if n != RETURN
    )
    out = cases.allocate(case, op, RETURN).zeros()()

    def to_np(x):
        if isinstance(x, tuple):
            return tuple(to_np(e) for e in x)
        return x.asnumpy() if hasattr(x, "asnumpy") else x

    extra = {} if comparison is None else {"comparison": comparison}
    cases.verify(case, op, *inps, ref=ref(*(to_np(x) for x in inps)), out=out, **extra)
    return out


def _np(v):
    return v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)


# -- test_feature_broadcast.py ------------------------------------------------------


@feature("broadcast")
def broadcast_simple(case):
    @gtx.field_operator
    def simple_broadcast(inp: IField) -> IJField:
        return broadcast(inp, (IDim, JDim))

    nj = case.default_sizes[JDim]
    return vdd(case, simple_broadcast,
               ref=lambda inp: np.broadcast_to(inp[:, np.newaxis], (inp.shape[0], nj)))


@feature("broadcast")
def broadcast_scalar(case):
    size = case.default_sizes[IDim]

    @gtx.field_operator
    def scalar_broadcast():
        return broadcast(1.0, (IDim,))

    out = zeros({IDim: size})
    cases.verify(case, scalar_broadcast, out=out, ref=np.ones(size))
    return out


@feature("broadcast")
def broadcast_two_fields(case):
    @gtx.field_operator
    def broadcast_two(inp1: IField, inp2: JField) -> IJField:
        a = broadcast(inp1, (IDim, JDim))
        b = broadcast(inp2, (IDim, JDim))
        return a + b

    return vdd(case, broadcast_two, ref=lambda a, b: a[:, np.newaxis] + b[np.newaxis, :])


@feature("broadcast")
def broadcast_shifted(case):
    @gtx.field_operator
    def broadcast_shift(inp: IField) -> IJField:
        bcasted = broadcast(inp, (IDim, JDim))
        return bcasted(JDim + 1)

    ni, nj = case.default_sizes[IDim], case.default_sizes[JDim]
    inp = cases.allocate(case, broadcast_shift, "inp").unique()()
    out = zeros({IDim: ni, JDim: nj})
    cases.verify(case, broadcast_shift, inp, out=out,
                 ref=np.broadcast_to(inp.asnumpy()[:, np.newaxis], (ni, nj)))
    return out


@feature("broadcast")
def zero_dims_fields(case):
    @gtx.field_operator
    def implicit_broadcast_scalar(inp: EmptyField) -> EmptyField:
        return inp

    inp = as_field(gtx.domain({}), np.asarray(1.0))
    out = as_field(gtx.domain({}), np.asarray(0.0))
    cases.verify(case, implicit_broadcast_scalar, inp, out=out, ref=np.asarray(1.0))
    return out


@feature("broadcast")
def implicit_broadcast_mixed_dim(case):
    @gtx.field_operator
    def fieldop_implicit_broadcast(zero_dim_inp: EmptyField, inp: IField,
                                   scalar: np.float64) -> IField:
        return inp + zero_dim_inp * scalar

    zero_dim = as_field(gtx.domain({}), np.asarray(1.0))
    inp = cases.allocate(case, fieldop_implicit_broadcast, "inp").unique()()
    out = cases.allocate(case, fieldop_implicit_broadcast, RETURN)()
    cases.verify(case, fieldop_implicit_broadcast, zero_dim, inp, np.float64(2.0), out=out,
                 ref=inp.asnumpy() + 2.0)
    return out


# -- test_feature_compiled_program.py -------------------------------------------------


@feature("compiled_program")
def compile_then_call_uses_pool(case):
    @gtx.field_operator
    def testee(a: IField, b: IField) -> IField:
        return a + b

    a = cases.allocate(case, testee, "a").unique()()
    b = cases.allocate(case, testee, "b").unique()()
    out = cases.allocate(case, testee, RETURN)()
    op = testee.with_backend(case.backend).compile(a, b, out=out, offset_provider={})
    n_before = len(op._pool)
    assert n_before >= 1
    cases.verify(case, op, a, b, out=out, ref=a.asnumpy() + b.asnumpy())
    assert len(op._pool) == n_before  # the call hit the precompiled entry
    return out


@feature("compiled_program")
def compile_kwargs(case):
    @gtx.field_operator
    def testee(a: IField, factor: np.float64) -> IField:
        return a * factor

    a = cases.allocate(case, testee, "a").unique()()
    out = cases.allocate(case, testee, RETURN)()
    op = testee.with_backend(case.backend).compile(
        a, factor=np.float64(2.0), out=out, offset_provider={})
    cases.verify(case, op, a, np.float64(2.0), out=out, ref=a.asnumpy() * 2.0)
    return out


@feature("compiled_program")
def compile_scan(case):
    @gtx.scan_operator(axis=KDim, forward=True, init=0.0)
    def cumsum(state: float, a: float) -> float:
        return state + a

    nk = 10
    a = as_field([KDim], np.arange(nk, dtype=np.float64))
    out = zeros({KDim: nk})
    cumsum.with_backend(case.backend)(a, out=out, offset_provider={})
    assert np.allclose(out.asnumpy(), np.cumsum(np.arange(nk)))
    return out


@feature("compiled_program", grid="unstructured")
def compile_for_two_offset_providers(case):
    @gtx.field_operator
    def testee(inp: EField) -> VField:
        return neighbor_sum(inp(V2E), axis=V2EDim)

    op = testee.with_backend(case.backend)
    ne, nv = case.default_sizes[Edge], case.default_sizes[Vertex]
    v2e_b = V2E_TABLE[:, ::-1].copy()
    prov_b = {
        "V2E": connectivity([Vertex, V2EDim], Edge, v2e_b),
        "E2V": case.offset_provider["E2V"],
    }
    rng = np.random.default_rng(41)
    inp = as_field([Edge], rng.random(ne))
    out_a = zeros({Vertex: nv})
    out_b = zeros({Vertex: nv})
    op(inp, out=out_a, offset_provider=case.offset_provider)
    op(inp, out=out_b, offset_provider=prov_b)
    ref = np.sum(inp.asnumpy()[V2E_TABLE], axis=1)
    assert np.allclose(out_a.asnumpy(), ref) and np.allclose(out_b.asnumpy(), ref)
    if case.backend in ("jax", "torch"):
        assert len(op._pool) >= 2
    return out_a, out_b


@feature("compiled_program", grid="unstructured",
         raises=("Exception", "(?i)v2e|offset|provider"))
def wrong_offset_provider_errors(case):
    @gtx.field_operator
    def testee(inp: EField) -> VField:
        return neighbor_sum(inp(V2E), axis=V2EDim)

    inp = as_field([Edge], np.ones(case.default_sizes[Edge]))
    out = zeros({Vertex: case.default_sizes[Vertex]})
    testee.with_backend(case.backend)(
        inp, out=out, offset_provider={"WRONG_NAME": case.offset_provider["E2V"]})


@feature("compiled_program")
def static_param_variants_compile_list(case):
    @gtx.field_operator
    def testee(a: IField, mode: np.int64) -> IField:
        return a + 1.0 if mode == 1 else a - 1.0

    op = testee.with_backend(case.backend).with_compilation_options(static_params=("mode",))
    a = cases.allocate(case, testee, "a").unique()()
    out1 = cases.allocate(case, testee, RETURN)()
    out2 = cases.allocate(case, testee, RETURN)()
    op = op.compile(a, mode=[np.int64(1), np.int64(2)], out=out1, offset_provider={})
    assert len(op._pool) >= 2
    op(a, np.int64(1), out=out1, offset_provider={})
    op(a, np.int64(2), out=out2, offset_provider={})
    assert np.allclose(out1.asnumpy(), a.asnumpy() + 1.0)
    assert np.allclose(out2.asnumpy(), a.asnumpy() - 1.0)
    return out1, out2


@feature("compiled_program")
def direct_scan_operator_call_embedded(case):
    @gtx.scan_operator(axis=KDim, forward=True, init=0.0, backend=None)
    def cumsum(state: float, a: float) -> float:
        return state + a

    nk = 7
    a = as_field([KDim], np.arange(nk, dtype=np.float64))
    out = zeros({KDim: nk})
    cumsum.with_backend(case.backend)(a, out=out, offset_provider={})
    assert np.allclose(out.asnumpy(), np.cumsum(np.arange(nk)))
    return out


# -- test_feature_conditionals.py ---------------------------------------------------

_BOOLS = ((True,), (False,))
_BOOL_PAIRS = ((True, True), (True, False), (False, True), (False, False))
_LEFT_RIGHT = ((2, 3), (3, 2))


def _ab(case, op):
    a = cases.allocate(case, op, "a")()
    b = cases.allocate(case, op, "b")()
    out = cases.allocate(case, op, RETURN)()
    return a, b, out


@feature("conditionals", params=_BOOLS)
def simple_if(case, condition):
    @gtx.field_operator
    def simple_if(a: IField, b: IField, condition: bool) -> IField:
        if condition:
            result = a
        else:
            result = b
        return result

    a, b, out = _ab(case, simple_if)
    cases.verify(case, simple_if, a, b, condition, out=out, ref=a if condition else b)
    return out


@feature("conditionals", params=_BOOL_PAIRS)
def if_two_names_then_ternary(case, condition1, condition2):
    @gtx.field_operator
    def simple_if(a: IField, b: IField, condition1: bool, condition2: bool) -> IField:
        if condition1:
            result1 = a
            result2 = a + 1.0
        else:
            result1 = b
            result2 = b + 1.0
        return result1 if condition2 else result2

    a, b, out = _ab(case, simple_if)
    base = a.asnumpy() if condition1 else b.asnumpy()
    cases.verify(case, simple_if, a, b, condition1, condition2, out=out,
                 ref=base + (0.0 if condition2 else 1.0))
    return out


@feature("conditionals", params=_BOOLS)
def branch_local_temporaries(case, condition):
    @gtx.field_operator
    def temporary_if(a: IField, b: IField, condition: bool) -> IField:
        if condition:
            tmp1 = a
            result = tmp1
        else:
            tmp2 = b
            result = tmp2
        return result

    a, b, out = _ab(case, temporary_if)
    cases.verify(case, temporary_if, a, b, condition, out=out, ref=a if condition else b)
    return out


@feature("conditionals", params=_BOOLS)
def if_both_branches_return(case, condition):
    @gtx.field_operator
    def both_return(a: IField, b: IField, condition: bool) -> IField:
        if condition:
            tmp1 = a
            return tmp1
        else:
            tmp2 = b
            return tmp2

    a, b, out = _ab(case, both_return)
    cases.verify(case, both_return, a, b, condition, out=out, ref=a if condition else b)
    return out


@feature("conditionals", params=_BOOLS)
def if_branch_returns_else_falls_through(case, condition):
    @gtx.field_operator
    def if_branch_returns(a: IField, b: IField, condition: bool) -> IField:
        if condition:
            tmp1 = a
            return tmp1
        return b

    a, b, out = _ab(case, if_branch_returns)
    cases.verify(case, if_branch_returns, a, b, condition, out=out, ref=a if condition else b)
    return out


@feature("conditionals", params=_BOOLS)
def else_branch_returns_if_falls_through(case, condition):
    @gtx.field_operator
    def else_branch_returns(a: IField, b: IField, condition: bool) -> IField:
        if condition:
            pass
        else:
            tmp1 = b
            return tmp1
        return a

    a, b, out = _ab(case, else_branch_returns)
    cases.verify(case, else_branch_returns, a, b, condition, out=out, ref=a if condition else b)
    return out


@feature("conditionals", params=_BOOL_PAIRS)
def nested_if_stmt_conditional_return(case, condition1, condition2):
    @gtx.field_operator
    def nested(inp: IField, condition1: bool, condition2: bool) -> IField:
        if condition1:
            tmp1 = inp
            if condition2:
                return tmp1 + 1.0
            result = tmp1 + 2.0
        else:
            result = inp + 3.0
        return result

    inp = cases.allocate(case, nested, "inp")()
    out = cases.allocate(case, nested, RETURN)()
    add = {(True, True): 1.0, (True, False): 2.0}.get((condition1, condition2), 3.0)
    cases.verify(case, nested, inp, condition1, condition2, out=out, ref=inp.asnumpy() + add)
    return out


@feature("conditionals", params=_BOOLS)
def nested_if_scalar_temporaries(case, condition):
    @gtx.field_operator
    def nested_if(a: IField, b: IField, condition: bool) -> IField:
        if condition:
            if not condition:
                inner = a
            else:
                inner = a + 1.0
            result = inner
        else:
            result = b
            if condition:
                another_inner = 3.0
            else:
                another_inner = 5.0
            result = result + another_inner
        return result

    a, b, out = _ab(case, nested_if)
    cases.verify(case, nested_if, a, b, condition, out=out,
                 ref=a.asnumpy() + 1.0 if condition else b.asnumpy() + 5.0)
    return out


@feature("conditionals", params=_BOOL_PAIRS)
def if_without_else(case, condition1, condition2):
    @gtx.field_operator
    def if_without_else(a: IField, b: IField, condition1: bool, condition2: bool) -> IField:
        result = b + 1.0
        if condition1:
            if not condition2:
                inner = a
            else:
                inner = a + 2.0
            result = inner
        return result

    a, b, out = _ab(case, if_without_else)
    ref = {
        (True, True): a.asnumpy() + 2.0,
        (True, False): a.asnumpy(),
        (False, True): b.asnumpy() + 1.0,
        (False, False): b.asnumpy() + 1.0,
    }[(condition1, condition2)]
    cases.verify(case, if_without_else, a, b, condition1, condition2, out=out, ref=ref)
    return out


@feature("conditionals", raises=("DSLTypeError", "(?i)scalar"))
def if_non_scalar_condition_rejected(case):
    @gtx.field_operator
    def if_non_scalar(a: IField, b: IField) -> IField:
        result = a
        if a == b:
            result = b
        return result


@feature("conditionals", params=_LEFT_RIGHT)
def ternary_operator(case, left, right):
    @gtx.field_operator
    def testee(a: IField, b: IField, left: np.int64, right: np.int64) -> IField:
        return a if left < right else b

    a, b, out = _ab(case, testee)
    cases.verify(case, testee, a, b, np.int64(left), np.int64(right), out=out,
                 ref=a if left < right else b)
    return out


@feature("conditionals", params=_LEFT_RIGHT)
def ternary_operator_broadcast_literals(case, left, right):
    @gtx.field_operator
    def testee(left: np.int64, right: np.int64):
        return broadcast(3.0, (IDim,)) if left > right else broadcast(4.0, (IDim,))

    n = case.default_sizes[IDim]
    out = zeros({IDim: n})
    cases.verify(case, testee, np.int64(left), np.int64(right), out=out,
                 ref=np.full(n, 3.0) if left > right else np.full(n, 4.0))
    return out


@feature("conditionals", params=_LEFT_RIGHT)
def ternary_operator_tuple(case, left, right):
    @gtx.field_operator
    def testee(a: IField, b: IField, left: np.int64, right: np.int64) -> tuple[IField, IField]:
        return (a, b) if left < right else (b, a)

    a, b, out = _ab(case, testee)
    cases.verify(case, testee, a, b, np.int64(left), np.int64(right), out=out,
                 ref=(a, b) if left < right else (b, a))
    return out


# -- test_feature_domain.py ------------------------------------------------------------


@feature("domain")
def scalar_in_domain_spec_and_fo_call(case):
    @gtx.field_operator
    def testee_op(size: np.int64):
        return broadcast(size, (IDim,))

    @gtx.program
    def testee(size, out):
        testee_op(size, out=out, domain={IDim: (0, size)})

    size = case.default_sizes[IDim]
    out = zeros({IDim: size}, dtype=np.int64)
    cases.verify(case, testee, np.int64(size), out, inout=out,
                 ref=np.full(size, size, dtype=np.int64))
    return out


@feature("domain")
def single_value_field_sliced_out(case):
    @gtx.field_operator
    def testee_fo(a: IKField) -> IKField:
        return a

    @gtx.program
    def testee_prog(a):
        testee_fo(a, out=a[1:2, 3:4])

    a = cases.allocate(case, testee_fo, "a").unique()()
    ref = a.asnumpy().copy()
    cases.run(case, testee_prog, a)
    assert np.allclose(a.asnumpy(), ref)
    return a


@feature("domain")
def domain_with_min_builtin(case):
    @gtx.field_operator
    def fieldop_domain(a: IField) -> IField:
        return a + a

    @gtx.program
    def program_domain(a, size, out):
        fieldop_domain(a, out=out, domain={IDim: (minimum(1, 2), size)})

    a = cases.allocate(case, fieldop_domain, "a").unique()()
    size = case.default_sizes[IDim]
    out = zeros({IDim: size})
    ref = out.asnumpy().copy()
    ref[1:size] = a.asnumpy()[1:size] * 2
    cases.verify(case, program_domain, a, np.int64(size), out, inout=out, ref=ref)
    return out


@feature("domain")
def domain_input_bounds_arithmetic(case):
    lower_i, upper_i = 1, case.default_sizes[IDim] + 1

    @gtx.field_operator
    def fieldop_domain(a: IField) -> IField:
        return a + a

    @gtx.program
    def program_domain(inp, out, lower_i, upper_i):
        fieldop_domain(inp, out=out, domain={IDim: (lower_i, upper_i // 2)})

    inp = cases.allocate(case, fieldop_domain, "a").unique()()
    out = zeros({IDim: case.default_sizes[IDim]})
    ref = out.asnumpy().copy()
    ref[lower_i: upper_i // 2] = inp.asnumpy()[lower_i: upper_i // 2] * 2
    cases.verify(case, program_domain, inp, out, np.int64(lower_i), np.int64(upper_i),
                 inout=out, ref=ref)
    return out


@feature("domain")
def domain_input_bounds_2d_mixed_arithmetic(case):
    ni, nj = case.default_sizes[IDim], case.default_sizes[JDim]
    lower_i, upper_i = 1, ni
    lower_j, upper_j = nj - 3, nj - 1

    @gtx.field_operator
    def fieldop_domain(a: IJField) -> IJField:
        return a + a

    @gtx.program
    def program_domain(a, out, lower_i, upper_i, lower_j, upper_j):
        fieldop_domain(
            a,
            out=out,
            domain={IDim: (1 * lower_i, upper_i + 0), JDim: (lower_j - 0, upper_j)},
        )

    a = cases.allocate(case, fieldop_domain, "a").unique()()
    out = zeros({IDim: ni, JDim: nj})
    ref = out.asnumpy().copy()
    ref[lower_i:upper_i, lower_j:upper_j] = a.asnumpy()[lower_i:upper_i, lower_j:upper_j] * 2
    cases.verify(case, program_domain, a, out, np.int64(lower_i), np.int64(upper_i),
                 np.int64(lower_j), np.int64(upper_j), inout=out, ref=ref)
    return out


@feature("domain")
def domain_tuple_outputs(case):
    @gtx.field_operator
    def fieldop_domain_tuple(a: IJField, b: IJField) -> tuple[IJField, IJField]:
        return (a + b, b)

    @gtx.program
    def program_domain_tuple(inp0, inp1, out0, out1, isize, jsize):
        fieldop_domain_tuple(
            inp0, inp1, out=(out0, out1),
            domain={IDim: (1, isize), JDim: (jsize - 2, jsize)},
        )

    ni, nj = case.default_sizes[IDim], case.default_sizes[JDim]
    inp0 = cases.allocate(case, fieldop_domain_tuple, "a").unique()()
    inp1 = cases.allocate(case, fieldop_domain_tuple, "b").unique()()
    out0, out1 = zeros({IDim: ni, JDim: nj}), zeros({IDim: ni, JDim: nj})
    isize, jsize = ni, nj - 1
    sl = (slice(1, isize), slice(jsize - 2, jsize))
    ref0, ref1 = out0.asnumpy().copy(), out1.asnumpy().copy()
    ref0[sl] = inp0.asnumpy()[sl] + inp1.asnumpy()[sl]
    ref1[sl] = inp1.asnumpy()[sl]
    cases.verify(case, program_domain_tuple, inp0, inp1, out0, out1, np.int64(isize),
                 np.int64(jsize), inout=(out0, out1), ref=(ref0, ref1))
    return out0, out1


# -- test_feature_multiple_output_domains.py --------------------------------------------


@gtx.field_operator
def fop_original(a: IField, b: IField) -> tuple[IField, IField]:
    return b, a


@gtx.field_operator
def fop_different_fields(a: IField, b: JField) -> tuple[JField, IField]:
    return b, a


def _ij_fields(case, seed):
    ni, nj = case.default_sizes[IDim], case.default_sizes[JDim]
    rng = np.random.default_rng(seed)
    a = as_field([IDim], rng.random(ni))
    b = as_field([JDim], rng.random(nj))
    return a, b, zeros({IDim: ni}), zeros({JDim: nj})


@feature("multiple_output_domains")
def program_single_shared_domain(case):
    @gtx.program
    def prog_orig(a, b, out_a, out_b, i_size):
        fop_original(a, b, out=(out_b, out_a), domain={IDim: (0, i_size)})

    n = case.default_sizes[IDim]
    a = cases.allocate(case, fop_original, "a").unique()()
    b = cases.allocate(case, fop_original, "b").unique()()
    out_a, out_b = zeros({IDim: n}), zeros({IDim: n})
    cases.verify(case, prog_orig, a, b, out_a, out_b, np.int64(n), inout=(out_b, out_a),
                 ref=(b, a))
    return out_a, out_b


@feature("multiple_output_domains")
def program_per_output_domains(case):
    @gtx.program
    def prog(a, b, out_a, out_b, i_size, j_size):
        fop_different_fields(
            a, b, out=(out_b, out_a), domain=({JDim: (0, j_size)}, {IDim: (0, i_size)}),
        )

    a, b, out_a, out_b = _ij_fields(case, 61)
    ni, nj = case.default_sizes[IDim], case.default_sizes[JDim]
    cases.verify(case, prog, a, b, out_a, out_b, np.int64(ni), np.int64(nj),
                 inout=(out_b, out_a), ref=(b, a))
    return out_a, out_b


@feature("multiple_output_domains")
def operator_call_per_output_domains(case):
    ni, nj = case.default_sizes[IDim], case.default_sizes[JDim]
    a, b, out_a, out_b = _ij_fields(case, 62)
    fop_different_fields.with_backend(case.backend)(
        a, b, out=(out_b, out_a), domain=({JDim: (0, nj - 2)}, {IDim: (1, ni)}),
        offset_provider={},
    )
    assert np.allclose(out_b.asnumpy()[: nj - 2], b.asnumpy()[: nj - 2])
    assert np.all(out_b.asnumpy()[nj - 2:] == 0.0)
    assert np.allclose(out_a.asnumpy()[1:], a.asnumpy()[1:]) and out_a.asnumpy()[0] == 0.0
    return out_a, out_b


@feature("multiple_output_domains")
def program_no_domain_different_fields(case):
    @gtx.program
    def prog_no_domain(a, b, out_a, out_b):
        fop_different_fields(a, b, out=(out_b, out_a))

    a, b, out_a, out_b = _ij_fields(case, 63)
    cases.verify(case, prog_no_domain, a, b, out_a, out_b, inout=(out_b, out_a), ref=(b, a))
    return out_a, out_b


@feature("multiple_output_domains")
def program_sliced_tuple_out(case):
    @gtx.program
    def prog_slicing(a, b, out_a, out_b):
        fop_different_fields(a, b, out=(out_b[2:-2], out_a[1:-1]))

    a, b, out_a, out_b = _ij_fields(case, 64)
    cases.run(case, prog_slicing, a, b, out_a, out_b)
    assert np.allclose(out_b.asnumpy()[2:-2], b.asnumpy()[2:-2])
    assert np.all(out_b.asnumpy()[:2] == 0.0) and np.all(out_b.asnumpy()[-2:] == 0.0)
    assert np.allclose(out_a.asnumpy()[1:-1], a.asnumpy()[1:-1])
    assert out_a.asnumpy()[0] == 0.0 and out_a.asnumpy()[-1] == 0.0
    return out_a, out_b


# -- test_feature_named_collections.py ---------------------------------------------------


class VelTuple(NamedTuple):
    u: gtx.Field[gtx.Dims[IDim, JDim], np.float64]
    v: gtx.Field[gtx.Dims[IDim, JDim], np.float64]


@named_collection
class VelClass:
    u: object
    v: object


class Pack(NamedTuple):
    vel: VelTuple
    w: gtx.Field[gtx.Dims[IDim, JDim], np.float64]


class Carry(NamedTuple):
    total: float
    prev: float


class Pair(NamedTuple):
    a: KField
    b: KField


def _uv(case):
    rng = np.random.default_rng(11)
    shape = (case.default_sizes[IDim], case.default_sizes[JDim])
    return as_field([IDim, JDim], rng.random(shape)), as_field([IDim, JDim], rng.random(shape))


@feature("named_collections")
def named_tuple_constructed_outside(case):
    @gtx.field_operator
    def testee(vel: VelTuple) -> IJField:
        return vel.u + vel.v

    u, v = _uv(case)
    out = zeros({IDim: u.shape[0], JDim: u.shape[1]})
    cases.verify(case, testee, VelTuple(u=u, v=v), out=out, ref=u.asnumpy() + v.asnumpy())
    return out


@feature("named_collections")
def collection_class_constructed_outside(case):
    @gtx.field_operator
    def testee(vel: VelClass) -> IJField:
        return vel.u + vel.v

    u, v = _uv(case)
    out = zeros({IDim: u.shape[0], JDim: u.shape[1]})
    cases.verify(case, testee, VelClass(u=u, v=v), out=out, ref=u.asnumpy() + v.asnumpy())
    return out


@feature("named_collections")
def named_tuple_constructed_inside(case):
    @gtx.field_operator
    def testee(vel: tuple[IJField, IJField]) -> VelTuple:
        return VelTuple(v=vel[0] - vel[1], u=vel[0] + vel[1])

    u, v = _uv(case)
    shape = u.shape
    out = VelTuple(u=zeros({IDim: shape[0], JDim: shape[1]}),
                   v=zeros({IDim: shape[0], JDim: shape[1]}))
    cases.run(case, testee, (u, v), out=out)
    assert np.allclose(out.u.asnumpy(), u.asnumpy() + v.asnumpy())
    assert np.allclose(out.v.asnumpy(), u.asnumpy() - v.asnumpy())
    return tuple(out)


@feature("named_collections")
def nested_mixed_collections(case):
    @gtx.field_operator
    def testee(pack: Pack) -> IJField:
        return pack.vel.u + pack.vel.v * pack.w

    u, v = _uv(case)
    w = as_field([IDim, JDim], np.full(u.shape, 2.0))
    out = zeros({IDim: u.shape[0], JDim: u.shape[1]})
    cases.verify(case, testee, Pack(vel=VelTuple(u=u, v=v), w=w), out=out,
                 ref=u.asnumpy() + v.asnumpy() * 2.0)
    return out


@feature("named_collections")
def scan_with_named_tuple_carry(case):
    @gtx.scan_operator(axis=KDim, init=Carry(total=0.0, prev=0.0), forward=True)
    def scan_op(carry: Carry, a: float) -> Carry:
        return Carry(total=carry.total + a, prev=a)

    nk = case.default_sizes[KDim]
    a = as_field([KDim], np.random.default_rng(12).random(nk))
    out = (zeros({KDim: nk}), zeros({KDim: nk}))
    cases.run(case, scan_op, a, out=out)
    assert np.allclose(out[0].asnumpy(), np.cumsum(a.asnumpy()))
    assert np.allclose(out[1].asnumpy(), a.asnumpy())
    return out


@feature("named_collections")
def where_over_collection(case):
    @gtx.field_operator
    def testee(mask: gtx.Field[gtx.Dims[IDim, JDim], bool], vel: VelTuple) -> VelTuple:
        return where(mask, vel, VelTuple(u=vel.v, v=vel.u))

    u, v = _uv(case)
    m = np.random.default_rng(13).random(u.shape) > 0.5
    mask = as_field([IDim, JDim], m)
    out = VelTuple(u=zeros({IDim: u.shape[0], JDim: u.shape[1]}),
                   v=zeros({IDim: u.shape[0], JDim: u.shape[1]}))
    cases.run(case, testee, mask, VelTuple(u=u, v=v), out=out)
    assert np.allclose(out.u.asnumpy(), np.where(m, u.asnumpy(), v.asnumpy()))
    assert np.allclose(out.v.asnumpy(), np.where(m, v.asnumpy(), u.asnumpy()))
    return tuple(out)


@feature("named_collections")
def concat_where_over_collection(case):
    @gtx.field_operator
    def testee(x: Pair, y: Pair) -> Pair:
        return concat_where(KDim < 3, x, y)

    nk = case.default_sizes[KDim]
    rng = np.random.default_rng(14)
    xa, xb, ya, yb = (rng.random(nk) for _ in range(4))
    x = Pair(a=as_field([KDim], xa), b=as_field([KDim], xb))
    y = Pair(a=as_field([KDim], ya), b=as_field([KDim], yb))
    out = Pair(a=zeros({KDim: nk}), b=zeros({KDim: nk}))
    cases.run(case, testee, x, y, out=out)
    assert np.allclose(out.a.asnumpy(), np.where(np.arange(nk) < 3, xa, ya))
    assert np.allclose(out.b.asnumpy(), np.where(np.arange(nk) < 3, xb, yb))
    return tuple(out)


# -- test_feature_operators.py ------------------------------------------------------------


@feature("operators")
def arithmetic(case):
    @gtx.field_operator
    def arithmetic(inp1: IField, inp2: IField) -> IField:
        return (inp1 + inp2 / 3.0 - inp2) * 2.0

    return vdd(case, arithmetic, ref=lambda inp1, inp2: (inp1 + inp2 / 3.0 - inp2) * 2.0)


@feature("operators")
def power(case):
    @gtx.field_operator
    def power(inp1: IField) -> IField:
        return inp1**2

    return vdd(case, power, ref=lambda inp1: inp1**2)


def _minus_five(case):
    return case.as_field([IDim], np.arange(case.default_sizes[IDim], dtype=np.int64) - 5)


@feature("operators")
def floordiv(case):
    @gtx.field_operator
    def floor_div(inp1: IIntField):
        return inp1 // 2

    inp1 = _minus_five(case)
    out = zeros({IDim: case.default_sizes[IDim]}, dtype=np.int64)
    cases.verify(case, floor_div, inp1, out=out, ref=inp1.asnumpy() // 2)
    return out


@feature("operators")
def mod_negative_operands(case):
    @gtx.field_operator
    def mod_fieldop(inp1: IIntField):
        return inp1 % 2

    inp1 = _minus_five(case)
    out = zeros({IDim: case.default_sizes[IDim]}, dtype=np.int64)
    cases.verify(case, mod_fieldop, inp1, out=out, ref=inp1.asnumpy() % 2)
    return out


@feature("operators", params=(("xor",), ("and",), ("or",)))
def bit_ops(case, opname):
    @gtx.field_operator
    def bit_xor(inp1: IBoolField, inp2: IBoolField) -> IBoolField:
        return inp1 ^ inp2

    @gtx.field_operator
    def bit_and(inp1: IBoolField, inp2: IBoolField) -> IBoolField:
        return inp1 & inp2

    @gtx.field_operator
    def bit_or(inp1: IBoolField, inp2: IBoolField) -> IBoolField:
        return inp1 | inp2

    op = {"xor": bit_xor, "and": bit_and, "or": bit_or}[opname]
    np_op = {"xor": np.logical_xor, "and": np.logical_and, "or": np.logical_or}[opname]
    size = case.default_sizes[IDim]
    rng = np.random.default_rng(7)
    inp1 = case.as_field([IDim], rng.random(size) > 0.5)
    inp2 = case.as_field([IDim], rng.random(size) > 0.5)
    out = zeros({IDim: size}, dtype=bool)
    cases.verify(case, op, inp1, inp2, out=out, ref=np_op(inp1.asnumpy(), inp2.asnumpy()))
    return out


@feature("operators")
def unary_neg(case):
    @gtx.field_operator
    def uneg(inp: IField) -> IField:
        return -inp

    return vdd(case, uneg, ref=lambda inp1: -inp1)


@feature("operators")
def unary_pos(case):
    @gtx.field_operator
    def upos(inp: IField) -> IField:
        return +inp

    return vdd(case, upos, ref=lambda inp1: inp1)


@feature("operators")
def unary_neg_float_literal_broadcast(case):
    @gtx.field_operator
    def uneg_float():
        return broadcast(float(-1), (IDim,))

    size = case.default_sizes[IDim]
    out = zeros({IDim: size})
    cases.verify(case, uneg_float, out=out, ref=np.full(size, -1.0))
    return out


@feature("operators")
def unary_bool_literal_broadcast(case):
    @gtx.field_operator
    def uneg_bool():
        return broadcast(bool(-1), (IDim,))

    size = case.default_sizes[IDim]
    out = zeros({IDim: size}, dtype=bool)
    cases.verify(case, uneg_bool, out=out, ref=np.full(size, True))
    return out


@feature("operators")
def unary_invert(case):
    @gtx.field_operator
    def tilde_fieldop(inp1: IBoolField) -> IBoolField:
        return ~inp1

    size = case.default_sizes[IDim]
    inp1 = case.as_field([IDim], np.random.default_rng(8).random(size) > 0.5)
    out = zeros({IDim: size}, dtype=bool)
    cases.verify(case, tilde_fieldop, inp1, out=out, ref=~inp1.asnumpy())
    return out


@feature("operators")
def copy_through_tuple_unpack(case):
    @gtx.field_operator
    def testee(a: IJKField) -> IJKField:
        field_tuple = (a, a)
        field_0 = field_tuple[0]
        field_1 = field_tuple[1]  # noqa: F841
        return field_0

    return vdd(case, testee, ref=lambda a: a)


def _special_literal(case, op, value):
    """A broadcast inf or nan literal; constant folding may raise
    ZeroDivisionError while tracing, which the test accepts (the out field
    then stays zero)."""
    size = case.default_sizes[IDim]
    out = zeros({IDim: size})
    try:
        cases.verify(case, op, out=out, ref=np.full(size, value),
                     comparison=lambda r, o: np.array_equal(r, _np(o), equal_nan=True))
    except ZeroDivisionError:
        pass
    return out


@feature("operators")
def infinity_literal(case):
    @gtx.field_operator
    def testee():
        return broadcast(1.0 / 0.0, (IDim,))

    return _special_literal(case, testee, np.inf)


@feature("operators")
def nan_literal(case):
    @gtx.field_operator
    def testee():
        return broadcast(0.0 / 0.0, (IDim,))

    return _special_literal(case, testee, np.nan)


@feature("operators")
def docstring_preserved(case):
    @gtx.field_operator
    def fieldop_with_docstring(a: IField) -> IField:
        """My operator docstring."""
        return a

    @gtx.program
    def prog_with_docstring(a):
        """My program docstring."""
        fieldop_with_docstring(a, out=a)

    a = cases.allocate(case, fieldop_with_docstring, "a").unique()()
    ref = a.asnumpy().copy()
    cases.run(case, prog_with_docstring, a)
    assert np.allclose(a.asnumpy(), ref)
    assert fieldop_with_docstring.__doc__ == "My operator docstring."
    return a


# -- test_feature_program.py ---------------------------------------------------------------


@feature("program")
def identity_fo_execution(case):
    @gtx.field_operator
    def identity(in_field: IField) -> IField:
        return in_field

    size = case.default_sizes[IDim]
    in_field, out_field = ones({IDim: size}), zeros({IDim: size})
    cases.verify(case, identity, in_field, out=out_field, ref=np.ones(size))
    return out_field


@feature("program")
def shift_by_one_sliced_out_execution(case):
    @gtx.field_operator
    def shift_by_one(in_field: IField) -> IField:
        return in_field(IDim + 1)

    @gtx.program
    def shift_by_one_program(in_field, out_field):
        shift_by_one(in_field, out=out_field[:-1])

    size = case.default_sizes[IDim]
    in_field = cases.allocate(case, shift_by_one, "in_field").extend({IDim: (0, 1)}).unique()()
    out_field = zeros({IDim: size})
    cases.run(case, shift_by_one_program, in_field, out_field)
    assert np.allclose(out_field.asnumpy()[:-1], in_field.asnumpy()[1:-1])
    assert out_field.asnumpy()[-1] == 0.0
    return out_field


@feature("program")
def double_copy_execution(case):
    @gtx.field_operator
    def copy(inp: IField) -> IField:
        return inp

    @gtx.program
    def double_copy_program(in_field, intermediate_field, out):
        copy(in_field, out=intermediate_field)
        copy(intermediate_field, out=out)

    in_field = cases.allocate(case, copy, "inp").unique()()
    size = case.default_sizes[IDim]
    intermediate, out = zeros({IDim: size}), zeros({IDim: size})
    cases.verify(case, double_copy_program, in_field, intermediate, out, inout=out,
                 ref=in_field.asnumpy())
    return intermediate, out


@feature("program")
def calling_fo_from_fo_in_program(case):
    @gtx.field_operator
    def pow_two(field: IField) -> IField:
        return field * field

    @gtx.field_operator
    def pow_three(field: IField) -> IField:
        return field * pow_two(field)

    @gtx.program
    def fo_from_fo_program(in_field, out):
        pow_three(in_field, out=out)

    in_field = cases.allocate(case, pow_three, "field").unique()()
    out = zeros({IDim: case.default_sizes[IDim]})
    cases.verify(case, fo_from_fo_program, in_field, out, inout=out,
                 ref=in_field.asnumpy() ** 3)
    return out


@feature("program")
def tuple_program_return_constructed_inside(case):
    @gtx.field_operator
    def pack_tuple(a: IField, b: IField) -> tuple[IField, IField]:
        return (a, b)

    @gtx.program
    def prog(a, b, out_a, out_b):
        pack_tuple(a, b, out=(out_a, out_b))

    a = cases.allocate(case, pack_tuple, "a").unique()()
    b = cases.allocate(case, pack_tuple, "b").unique()()
    size = case.default_sizes[IDim]
    out_a, out_b = zeros({IDim: size}), zeros({IDim: size})
    cases.verify(case, prog, a, b, out_a, out_b, inout=(out_a, out_b), ref=(a, b))
    return out_a, out_b


@feature("program")
def tuple_program_return_constructed_inside_with_slicing(case):
    @gtx.field_operator
    def pack_tuple(a: IField, b: IField) -> tuple[IField, IField]:
        return (a, b)

    @gtx.program
    def prog(a, b, out_a, out_b):
        pack_tuple(a, b, out=(out_a[1:], out_b[1:]))

    size = case.default_sizes[IDim]
    a, b = ones({IDim: size}), as_field([IDim], np.full(size, 2.0))
    out_a, out_b = zeros({IDim: size}), zeros({IDim: size})
    cases.run(case, prog, a, b, out_a, out_b)
    assert np.allclose(out_a.asnumpy()[1:], a.asnumpy()[1:])
    assert np.allclose(out_b.asnumpy()[1:], b.asnumpy()[1:])
    assert out_a.asnumpy()[0] == 0.0 and out_b.asnumpy()[0] == 0.0
    return out_a, out_b


@feature("program")
def tuple_program_return_constructed_inside_nested(case):
    @gtx.field_operator
    def pack_tuple(a: IField, b: IField, c: IField) -> tuple[tuple[IField, IField], IField]:
        return ((a, b), c)

    @gtx.program
    def prog(a, b, c, out_a, out_b, out_c):
        pack_tuple(a, b, c, out=((out_a, out_b), out_c))

    size = case.default_sizes[IDim]
    a = ones({IDim: size})
    b = as_field([IDim], np.full(size, 2.0))
    c = as_field([IDim], np.full(size, 3.0))
    out_a, out_b, out_c = (zeros({IDim: size}) for _ in range(3))
    cases.verify(case, prog, a, b, c, out_a, out_b, out_c, inout=((out_a, out_b), out_c),
                 ref=((a, b), c))
    return out_a, out_b, out_c


@feature("program", raises=("Exception", "(?i)idim|dimension|dims|type"))
def wrong_argument_dims_rejected(case):
    @gtx.field_operator
    def identity(in_field: IField) -> IField:
        return in_field

    nj = case.default_sizes[JDim]
    inp = case.as_field([JDim], np.ones(nj))
    cases.run(case, identity, inp, out=zeros({JDim: nj}))


@feature("program", raises=("Exception", "(?i)domain|dimension"))
def mismatched_domain_dims_rejected(case):
    @gtx.field_operator
    def fieldop(a: IField) -> IField:
        return a

    a = cases.allocate(case, fieldop, "a").unique()()
    out = zeros({IDim: case.default_sizes[IDim]})
    cases.run(case, fieldop, a, out=out, domain={JDim: (0, 1)})


@feature("program")
def out_field_with_non_zero_domain_start(case):
    @gtx.field_operator
    def copy(in_field: IField) -> IField:
        return in_field

    size = case.default_sizes[IDim]
    inp = cases.allocate(case, copy, "in_field").unique()()
    out = zeros({IDim: (1, size - 2)})
    cases.verify(case, copy, inp, out=out, ref=inp.asnumpy()[1: size - 2])
    return out


@feature("program")
def in_field_with_non_zero_domain_start(case):
    @gtx.field_operator
    def identity(a: IField) -> IField:
        return a

    size = case.default_sizes[IDim]
    inp = as_field(gtx.domain({IDim: (1, 9)}), np.full(8, 42.0))
    out = zeros({IDim: size})
    ref = out.asnumpy().copy()
    ref[1:9] = 42.0
    cases.verify(case, identity, inp, out=out, ref=ref, domain={IDim: (1, 9)})
    return out


# -- test_feature_reductions.py --------------------------------------------------------------


@feature("reductions", grid="unstructured")
def maxover_execution(case):
    @gtx.field_operator
    def testee(edge_f: EField) -> VField:
        return max_over(edge_f(V2E), axis=V2EDim)

    return vdd(case, testee, ref=lambda edge_f: np.max(edge_f[V2E_TABLE], axis=1))


@feature("reductions", grid="unstructured")
def minover_execution(case):
    @gtx.field_operator
    def testee(edge_f: EField) -> VField:
        return min_over(edge_f(V2E), axis=V2EDim)

    return vdd(case, testee, ref=lambda edge_f: np.min(edge_f[V2E_TABLE], axis=1))


@feature("reductions", grid="unstructured")
def reduction_expression_in_call(case):
    @gtx.field_operator
    def reduce_expr(edge_f: EField) -> VField:
        tmp_nbh_tup = edge_f(V2E), edge_f(V2E)
        tmp_nbh = tmp_nbh_tup[0]
        return 3.0 * neighbor_sum(-edge_f(V2E) * tmp_nbh * 2.0, axis=V2EDim)

    @gtx.program
    def fencil(edge_f, out):
        reduce_expr(edge_f, out=out)

    edge_f = cases.allocate(case, reduce_expr, "edge_f").unique()()
    out = zeros({Vertex: case.default_sizes[Vertex]})
    cases.verify(case, fencil, edge_f, out, inout=out,
                 ref=3.0 * np.sum(-(edge_f.asnumpy()[V2E_TABLE] ** 2) * 2.0, axis=1))
    return out


@feature("reductions", grid="unstructured")
def reduction_with_common_expression(case):
    @gtx.field_operator
    def testee(flux: EField) -> VField:
        return neighbor_sum(flux(V2E) + flux(V2E), axis=V2EDim)

    return vdd(case, testee, ref=lambda flux: np.sum(flux[V2E_TABLE] * 2.0, axis=1))


def _vertex_mask(case, seed):
    nv = case.default_sizes[Vertex]
    m = np.random.default_rng(seed).random(nv) > 0.5
    return m, case.as_field([Vertex], m), zeros({Vertex: nv})


@feature("reductions", grid="unstructured")
def reduction_expression_with_where(case):
    @gtx.field_operator
    def testee(mask: gtx.Field[gtx.Dims[Vertex], bool], inp: EField) -> VField:
        return neighbor_sum(where(mask, inp(V2E), inp(V2E)), axis=V2EDim)

    _, mask, out = _vertex_mask(case, 21)
    inp = cases.allocate(case, testee, "inp").unique()()
    cases.verify(case, testee, mask, inp, out=out, ref=np.sum(inp.asnumpy()[V2E_TABLE], axis=1))
    return out


@feature("reductions", grid="unstructured")
def reduction_expression_with_where_and_tuples(case):
    @gtx.field_operator
    def testee(mask: gtx.Field[gtx.Dims[Vertex], bool], inp: EField) -> VField:
        return neighbor_sum(
            where(mask, (inp(V2E), inp(V2E)), (inp(V2E), inp(V2E)))[1], axis=V2EDim,
        )

    _, mask, out = _vertex_mask(case, 22)
    inp = cases.allocate(case, testee, "inp").unique()()
    cases.verify(case, testee, mask, inp, out=out, ref=np.sum(inp.asnumpy()[V2E_TABLE], axis=1))
    return out


@feature("reductions", grid="unstructured")
def reduction_expression_with_where_and_scalar(case):
    @gtx.field_operator
    def testee(mask: gtx.Field[gtx.Dims[Vertex], bool], inp: EField) -> VField:
        return neighbor_sum(inp(V2E) + where(mask, inp(V2E), 1.0), axis=V2EDim)

    m, mask, out = _vertex_mask(case, 23)
    inp = cases.allocate(case, testee, "inp").unique()()
    gathered = inp.asnumpy()[V2E_TABLE]
    ref = np.sum(gathered + np.where(m[:, None], gathered, 1.0), axis=1)
    cases.verify(case, testee, mask, inp, out=out, ref=ref)
    return out


@feature("reductions", grid="unstructured")
def promotion_unstructured_k(case):
    @gtx.field_operator
    def promotion(
        inp1: gtx.Field[gtx.Dims[Edge, KDim], np.float64],
        inp2: gtx.Field[gtx.Dims[KDim], np.float64],
    ) -> gtx.Field[gtx.Dims[Edge, KDim], np.float64]:
        return inp1 / inp2

    ne = case.default_sizes[Edge]
    rng = np.random.default_rng(24)
    inp1 = as_field([Edge, KDim], rng.random((ne, 5)) + 1.0)
    inp2 = as_field([KDim], rng.random(5) + 1.0)
    out = zeros({Edge: ne, KDim: 5})
    cases.verify(case, promotion, inp1, inp2, out=out,
                 ref=inp1.asnumpy() / inp2.asnumpy()[None, :])
    return out


@feature("reductions", grid="unstructured")
def composed_unstructured_shift(case):
    @gtx.field_operator
    def shift_e2v(inp: VField) -> EField:
        return inp(E2V[0])

    @gtx.field_operator
    def composed_flat(inp: VField):
        return inp(E2V[0])(V2E[0])

    @gtx.field_operator
    def composed_intermediate(inp: VField):
        tmp = inp(E2V[0])
        return tmp(V2E[0])

    @gtx.field_operator
    def composed_through_call(inp: VField):
        return shift_e2v(inp)(V2E[0])

    inp = cases.allocate(case, shift_e2v, "inp").unique()()
    ref = inp.asnumpy()[E2V_TABLE[:, 0]][V2E_TABLE[:, 0]]
    outs = []
    for op in (composed_flat, composed_intermediate, composed_through_call):
        out = zeros({Vertex: case.default_sizes[Vertex]})
        cases.verify(case, op, inp, out=out, ref=ref)
        outs.append(out)
    return tuple(outs)


@feature("reductions", grid="unstructured")
def nested_reduction(case):
    @gtx.field_operator
    def testee(a: VField) -> VField:
        tmp = neighbor_sum(a(E2V), axis=E2VDim)
        tmp_2 = neighbor_sum(tmp(V2E), axis=V2EDim)
        return tmp_2

    return vdd(case, testee,
               ref=lambda a: np.sum(np.sum(a[E2V_TABLE], axis=1)[V2E_TABLE], axis=1))


@feature("reductions", grid="unstructured")
def tuple_with_local_field_in_reduction_shifted(case):
    @gtx.field_operator
    def reduce_tuple_element(e: EField, v: VField) -> EField:
        tup = e(V2E), v
        red = neighbor_sum(tup[0] + v, axis=V2EDim)
        tmp = red(E2V[0])
        return tmp

    e = cases.allocate(case, reduce_tuple_element, "e").unique()()
    v = cases.allocate(case, reduce_tuple_element, "v").unique()()
    out = zeros({Edge: case.default_sizes[Edge]})
    red = np.sum(e.asnumpy()[V2E_TABLE] + v.asnumpy()[:, None], axis=1)
    cases.verify(case, reduce_tuple_element, e, v, out=out, ref=red[E2V_TABLE[:, 0]])
    return out


@feature("reductions", grid="unstructured")
def ternary_builtin_neighbor_sum(case):
    @gtx.field_operator
    def testee(a: EField, b: EField) -> VField:
        tmp = neighbor_sum(b(V2E) if 2 < 3 else a(V2E), axis=V2EDim)
        return tmp

    return vdd(case, testee, ref=lambda a, b: np.sum(b[V2E_TABLE], axis=1))


@feature("reductions", grid="unstructured")
def local_index_premapped_field(case):
    @gtx.field_operator
    def testee(inp: gtx.Field[gtx.Dims[Edge], np.int64]):
        shifted = inp(V2E)
        return (
            shifted[V2EDim(0)] + shifted[V2EDim(1)]
            + shifted[V2EDim(2)] + shifted[V2EDim(3)]
        )

    inp = cases.allocate(case, testee, "inp").unique()()
    out = zeros({Vertex: case.default_sizes[Vertex]}, dtype=np.int64)
    cases.verify(case, testee, inp, out=out, ref=np.sum(inp.asnumpy()[V2E_TABLE], axis=1))
    return out


# -- test_feature_scalar_and_bound_args.py ---------------------------------------------------


@feature("scalar_and_bound_args", grid="unstructured")
def scalar_arg_broadcast(case):
    @gtx.field_operator
    def testee(a: np.int64):
        return broadcast(a + 1, (Vertex,))

    nv = case.default_sizes[Vertex]
    out = zeros({Vertex: nv}, dtype=np.int64)
    cases.verify(case, testee, np.int64(41), out=out, ref=np.full(nv, 42, dtype=np.int64))
    return out


@feature("scalar_and_bound_args", grid="unstructured")
def np_bool_scalar_arg(case):
    @gtx.field_operator
    def testee(a: bool):
        return broadcast(not a, (Vertex,))

    nv = case.default_sizes[Vertex]
    out = zeros({Vertex: nv}, dtype=bool)
    cases.verify(case, testee, np.bool_(True), out=out, ref=np.full(nv, False))
    return out


@feature("scalar_and_bound_args", grid="unstructured")
def nested_scalar_arg(case):
    @gtx.field_operator
    def testee_inner(a: np.int64):
        return broadcast(a + 1, (Vertex,))

    @gtx.field_operator
    def testee(a: np.int64):
        return testee_inner(a + 1)

    nv = case.default_sizes[Vertex]
    out = zeros({Vertex: nv}, dtype=np.int64)
    cases.verify(case, testee, np.int64(40), out=out, ref=np.full(nv, 42, dtype=np.int64))
    return out


@feature("scalar_and_bound_args")
def scalar_arg_with_field_and_shift(case):
    @gtx.field_operator
    def testee(a: IJKField, b: np.float64) -> IJKField:
        tmp = b * a
        return tmp(IDim + 1)

    a = cases.allocate(case, testee, "a").extend({IDim: (0, 1)}).unique()()
    b = np.float64(3.0)
    out = cases.allocate(case, testee, RETURN)()
    cases.verify(case, testee, a, b, out=out, ref=a.asnumpy()[1:] * b)
    return out


@feature("scalar_and_bound_args")
def double_use_scalar(case):
    @gtx.field_operator
    def testee(a: np.float64, b: np.float64, c: IField) -> IField:
        tmp = a * b
        tmp2 = tmp * tmp
        return tmp2 * tmp2 * c

    return vdd(case, testee, ref=lambda a, b, c: (a * b) ** 4 * c)


@feature("scalar_and_bound_args")
def with_bound_args(case):
    @gtx.field_operator
    def fieldop_bound_args(a: IField, scalar: np.float64, condition: bool) -> IField:
        if not condition:
            scalar = 0.0
        return a + scalar

    @gtx.program
    def program_bound_args(a, scalar, condition, out):
        fieldop_bound_args(a, scalar, condition, out=out)

    a = cases.allocate(case, fieldop_bound_args, "a").unique()()
    out = cases.allocate(case, fieldop_bound_args, RETURN)()
    prog_bounds = program_bound_args.with_bound_args(scalar=np.float64(1.0), condition=True)
    prog_bounds.with_backend(case.backend)(a, out=out, offset_provider={})
    assert np.allclose(out.asnumpy(), a.asnumpy() + 1.0)
    return out


@feature("scalar_and_bound_args")
def with_bound_args_order(case):
    @gtx.field_operator
    def fieldop_args(a: IField, condition: bool, scalar: np.float64) -> IField:
        scalar = 0.0 if not condition else scalar
        return a + scalar

    @gtx.program
    def program_args(a, condition, scalar, out):
        fieldop_args(a, condition, scalar, out=out)

    a = cases.allocate(case, fieldop_args, "a").unique()()
    out = cases.allocate(case, fieldop_args, RETURN)()
    prog_bounds = program_args.with_bound_args(condition=True)
    prog_bounds.with_backend(case.backend)(a=a, scalar=np.float64(1.0), out=out,
                                           offset_provider={})
    assert np.allclose(out.asnumpy(), a.asnumpy() + 1.0)
    return out


def _bound_args_testee():
    @gtx.field_operator
    def fieldop_zero():
        return broadcast(0.0, (IDim,))

    @gtx.program
    def program_bound_args(arg1, arg2, out):
        fieldop_zero(out=out)

    return program_bound_args


@feature("scalar_and_bound_args", raises=("TypeError", "not a valid program parameter"))
def bind_invalid_arg(case):
    _bound_args_testee().with_bound_args(inexistent_arg=1)


@feature("scalar_and_bound_args", raises=("TypeError", "already bound"))
def call_bound_program_with_already_bound_arg(case):
    program_with_bound_arg = _bound_args_testee().with_bound_args(arg2=True)
    out = zeros({IDim: case.default_sizes[IDim]})
    program_with_bound_arg.with_backend(case.backend)(True, out=out, arg2=True,
                                                      offset_provider={})


@feature("scalar_and_bound_args")
def constant_closure_vars_with_frozen_namespace(case):
    constants = FrozenNamespace(PI=np.float64(3.142), E=np.float64(2.718))

    @gtx.field_operator
    def consume_constants(inp: IField) -> IField:
        return constants.PI * constants.E * inp

    return vdd(case, consume_constants, ref=lambda inp: 3.142 * 2.718 * inp)


class Constants(np.float64, enum.Enum):
    PI = 3.142
    E = 2.718


@feature("scalar_and_bound_args")
def constant_closure_vars_with_enums(case):
    @gtx.field_operator
    def consume_constants(inp: IField) -> IField:
        return Constants.PI * Constants.E * inp

    return vdd(case, consume_constants, ref=lambda inp: 3.142 * 2.718 * inp)


# -- test_feature_scan.py ------------------------------------------------------------------


@feature("scan", params=((True,), (False,)))
def fieldop_from_scan(case, forward):
    init = 1.0
    k_size = case.default_sizes[KDim]
    expected = np.arange(init + 1.0, init + 1.0 + k_size, 1)
    if not forward:
        expected = np.flip(expected)

    @gtx.field_operator
    def add(carry: float, foo: float) -> float:
        return carry + foo

    @gtx.scan_operator(axis=KDim, forward=forward, init=init)
    def simple_scan_operator(carry: float) -> float:
        return add(carry, 1.0)

    out = zeros({KDim: k_size})
    cases.verify(case, simple_scan_operator, out=out, ref=expected)
    return out


@feature("scan")
def solve_triag(case):
    @gtx.scan_operator(axis=KDim, forward=True, init=(0.0, 0.0))
    def tridiag_forward(
        state: tuple[float, float], a: float, b: float, c: float, d: float
    ) -> tuple[float, float]:
        return (c / (b - a * state[0]), (d - a * state[1]) / (b - a * state[0]))

    @gtx.scan_operator(axis=KDim, forward=False, init=0.0)
    def tridiag_backward(x_kp1: float, cp: float, dp: float) -> float:
        return dp - cp * x_kp1

    @gtx.field_operator
    def solve_tridiag(a: IJKField, b: IJKField, c: IJKField, d: IJKField) -> IJKField:
        cp, dp = tridiag_forward(a, b, c, d)
        return tridiag_backward(cp, dp)

    shape = tuple(case.default_sizes[dim] for dim in (IDim, JDim, KDim))
    rng = np.random.default_rng(31)
    a = rng.random(shape)
    b = rng.random(shape) + 4.0  # diagonally dominant
    c = rng.random(shape)
    d = rng.random(shape)
    matrices = np.zeros(shape + shape[-1:])
    i = np.arange(shape[2])
    matrices[:, :, i[1:], i[:-1]] = a[:, :, 1:]
    matrices[:, :, i, i] = b
    matrices[:, :, i[:-1], i[1:]] = c[:, :, :-1]
    expected = np.linalg.solve(matrices, d[..., None])[..., 0]
    out = zeros({IDim: shape[0], JDim: shape[1], KDim: shape[2]})
    fields = [as_field([IDim, JDim, KDim], x) for x in (a, b, c, d)]
    cases.verify(case, solve_tridiag, *fields, out=out, ref=expected)
    return out


@feature("scan")
def scan_different_domain_in_tuple(case):
    init = 1.0
    i_size, k_size = case.default_sizes[IDim], case.default_sizes[KDim]
    inp1_np = np.ones((i_size + 1, k_size))  # one extra I row
    inp2_np = np.fromfunction(lambda i, k: k, shape=(i_size, k_size), dtype=float)
    inp1, inp2 = as_field([IDim, KDim], inp1_np), as_field([IDim, KDim], inp2_np)
    out = zeros({IDim: i_size, KDim: k_size})
    expected = np.asarray([
        reduce(lambda prev, k: prev + inp1_np[:-1, k] + inp2_np[:, k], range(k + 1), init)
        for k in range(k_size)
    ]).transpose()

    @gtx.scan_operator(axis=KDim, forward=True, init=init)
    def scan_op(carry: float, a: tuple[float, float]) -> float:
        return carry + a[0] + a[1]

    @gtx.field_operator
    def foo(
        inp1: gtx.Field[gtx.Dims[IDim, KDim], np.float64],
        inp2: gtx.Field[gtx.Dims[IDim, KDim], np.float64],
    ) -> gtx.Field[gtx.Dims[IDim, KDim], np.float64]:
        return scan_op((inp1, inp2))

    cases.verify(case, foo, inp1, inp2, out=out, ref=expected)
    return out


@feature("scan", raises=("DSLTypeError", "same type as its return"))
def scan_wrong_return_type(case):
    @gtx.scan_operator(axis=KDim, forward=True, init=0)
    def testee_scan(state: np.int32) -> float:
        return 1.0


@feature("scan", raises=("DSLTypeError", "'init'.*must have same type"))
def scan_wrong_init_type(case):
    @gtx.scan_operator(axis=KDim, forward=True, init=0)
    def testee_scan(state: float) -> float:
        return 1.0


@feature("scan", raises=("DSLTypeError", "at least one argument"))
def scan_without_carry(case):
    @gtx.scan_operator(axis=KDim, forward=True, init=0.0)
    def testee_scan() -> float:
        return 1.0


# -- test_feature_shifts_and_local_fields.py ------------------------------------------------


@feature("shifts_and_local_fields")
def cartesian_shift(case):
    @gtx.field_operator
    def testee(a: IJKField) -> IJKField:
        return a(IDim + 1)

    a = cases.allocate(case, testee, "a").extend({IDim: (0, 1)}).unique()()
    out = cases.allocate(case, testee, RETURN)()
    cases.verify(case, testee, a, out=out, ref=a.asnumpy()[1:])
    return out


@feature("shifts_and_local_fields")
def fold_shifts(case):
    @gtx.field_operator
    def testee(a: IJKField, b: IJKField) -> IJKField:
        tmp = a + b(IDim + 1)
        return tmp(IDim + 1)

    a = cases.allocate(case, testee, "a").extend({IDim: (0, 1)}).unique()()
    b = cases.allocate(case, testee, "b").extend({IDim: (0, 2)}).unique()()
    out = cases.allocate(case, testee, RETURN)()
    cases.verify(case, testee, a, b, out=out, ref=a.asnumpy()[1:] + b.asnumpy()[2:])
    return out


@feature("shifts_and_local_fields")
def offset_field(case):
    @gtx.field_operator
    def testee(a: IKField, offset_field: gtx.Field[gtx.Dims[IDim, KDim], np.int64]):
        a_i = a(as_offset(Ioff, offset_field))
        a_i_k = a_i(as_offset(Koff, offset_field))
        b_i = a(IDim + 1)
        b_i_k = b_i(KDim + 1)
        return a_i_k == b_i_k

    ni, nk = case.default_sizes[IDim], case.default_sizes[KDim]
    a = cases.allocate(case, testee, "a").extend({IDim: (0, 1), KDim: (0, 1)}).unique()()
    offset_field = as_field([IDim, KDim], np.ones((ni, nk + 1), dtype=np.int64))
    out = zeros({IDim: ni, KDim: nk}, dtype=bool)
    cases.verify(case, testee, a, offset_field, out=out, ref=np.full((ni, nk), True),
                 comparison=lambda ref, got: np.all(_np(got) == ref))
    return out


@feature("shifts_and_local_fields", grid="unstructured")
def external_local_field(case):
    @gtx.field_operator
    def testee(
        inp: gtx.Field[gtx.Dims[Vertex, V2EDim], np.int64],
        ones: gtx.Field[gtx.Dims[Edge], np.int64],
    ):
        return neighbor_sum(inp * ones(V2E), axis=V2EDim)

    inp = case.as_field([Vertex, V2EDim], V2E_TABLE)
    ones_e = as_field([Edge], np.ones(case.default_sizes[Edge], dtype=np.int64))
    out = zeros({Vertex: case.default_sizes[Vertex]}, dtype=np.int64)
    cases.verify(case, testee, inp, ones_e, out=out, ref=np.sum(V2E_TABLE, axis=1))
    return out


@feature("shifts_and_local_fields", grid="unstructured")
def index_external_local_field(case):
    @gtx.field_operator
    def testee(inp: gtx.Field[gtx.Dims[Vertex, V2EDim], np.int64]):
        return inp[V2EDim(0)] + inp[V2EDim(1)] + inp[V2EDim(2)] + inp[V2EDim(3)]

    inp = case.as_field([Vertex, V2EDim], V2E_TABLE)
    out = zeros({Vertex: case.default_sizes[Vertex]}, dtype=np.int64)
    cases.verify(case, testee, inp, out=out, ref=np.sum(V2E_TABLE, axis=1))
    return out


@feature("shifts_and_local_fields", grid="unstructured")
def index_external_local_field_with_cast(case):
    @gtx.field_operator
    def testee(inp: gtx.Field[gtx.Dims[Vertex, V2EDim], np.int32]):
        inp_64 = astype(inp, gtx.int64)
        return inp_64[V2EDim(0)] + inp_64[V2EDim(1)] + inp_64[V2EDim(2)] + inp_64[V2EDim(3)]

    inp = case.as_field([Vertex, V2EDim], V2E_TABLE.astype(np.int32))
    out = zeros({Vertex: case.default_sizes[Vertex]}, dtype=np.int64)
    cases.verify(case, testee, inp, out=out, ref=np.sum(V2E_TABLE, axis=1))
    assert out.dtype == np.dtype(np.int64)
    return out


@feature("shifts_and_local_fields", grid="unstructured")
def write_local_field(case):
    @gtx.field_operator
    def testee(inp: gtx.Field[gtx.Dims[Edge], np.int64]):
        return inp(V2E)

    inp = cases.allocate(case, testee, "inp").unique()()
    out = case.as_field([Vertex, V2EDim], np.zeros_like(V2E_TABLE))
    cases.verify(case, testee, inp, out=out, ref=inp.asnumpy()[V2E_TABLE])
    return out


# -- test_feature_tuples.py --------------------------------------------------------------


@feature("tuples")
def multicopy(case):
    @gtx.field_operator
    def testee(a: IJKField, b: IJKField) -> tuple[IJKField, IJKField]:
        return a, b

    return vdd(case, testee, ref=lambda a, b: (a, b))


@feature("tuples")
def tuples_of_scalars_fold(case):
    @gtx.field_operator
    def testee(a: IJKField, b: IJKField) -> IJKField:
        inps = a, b
        scalars = 1.3, 5.0, 3.4
        return (inps[0] * scalars[0] + inps[1] * scalars[1]) * scalars[2]

    return vdd(case, testee, ref=lambda a, b: (a * 1.3 + b * 5.0) * 3.4)


@feature("tuples", grid="unstructured")
def scalar_tuple_arg(case):
    @gtx.field_operator
    def testee(a: tuple[np.int64, tuple[np.int64, np.int64]]):
        return broadcast(a[0] + 2 * a[1][0] + 3 * a[1][1], (Vertex,))

    nv = case.default_sizes[Vertex]
    out = zeros({Vertex: nv}, dtype=np.int64)
    cases.verify(case, testee, (np.int64(7), (np.int64(11), np.int64(13))),
                 ref=np.full(nv, 7 + 2 * 11 + 3 * 13, dtype=np.int64), out=out)
    return out


@feature("tuples")
def mixed_field_scalar_tuple_arg(case):
    @gtx.field_operator
    def testee(a: tuple[np.float64, tuple[np.float64, IField, np.float64]]) -> IField:
        return a[0] + 2.0 * a[1][0] + 3.0 * a[1][1] + 5.0 * a[1][2]

    s0, (s1, fld, s2) = cases.allocate(case, testee, "a").unique()()
    out = cases.allocate(case, testee, RETURN).zeros()()
    cases.verify(case, testee, (s0, (s1, fld, s2)), out=out,
                 ref=s0 + 2.0 * s1 + 3.0 * fld.asnumpy() + 5.0 * s2)
    return out


@feature("tuples")
def tuple_arg_with_different_but_promotable_dims(case):
    @gtx.field_operator
    def testee(a: tuple[IField, IJField]) -> IJField:
        return a[0] + 2.0 * a[1]

    return vdd(case, testee, ref=lambda a: a[0][:, np.newaxis] + 2.0 * a[1])


@feature("tuples")
def nested_tuple_return_through_call(case):
    @gtx.field_operator
    def pack_tuple(a: IField, b: IField) -> tuple[IField, tuple[IField, IField]]:
        return (a, (a, b))

    @gtx.field_operator
    def combine(a: IField, b: IField) -> IField:
        packed = pack_tuple(a, b)
        return packed[0] + packed[1][0] + packed[1][1]

    return vdd(case, combine, ref=lambda a, b: a + a + b)


@feature("tuples", grid="unstructured")
def tuple_return_unstructured(case):
    @gtx.field_operator
    def testee(a: EField, b: EField):
        tmp = neighbor_sum(a(V2E), axis=V2EDim)
        tmp_2 = neighbor_sum(b(V2E), axis=V2EDim)
        return tmp, tmp_2

    nv = case.default_sizes[Vertex]
    a = cases.allocate(case, testee, "a").unique()()
    b = cases.allocate(case, testee, "b").unique()()
    out = (zeros({Vertex: nv}), zeros({Vertex: nv}))
    cases.verify(case, testee, a, b, out=out, ref=(
        a.asnumpy()[V2E_TABLE].sum(axis=1), b.asnumpy()[V2E_TABLE].sum(axis=1)))
    return out


@feature("tuples")
def nested_tuple_arg(case):
    @gtx.field_operator
    def testee(a: tuple[tuple[IField, IField], IField]) -> IField:
        return 3.0 * a[0][0] + a[0][1] + a[1]

    return vdd(case, testee, ref=lambda a: 3.0 * a[0][0] + a[0][1] + a[1])


@feature("tuples")
def tuple_unpacking(case):
    @gtx.field_operator
    def unpack(inp: IField) -> tuple[IField, IField, IField, IField]:
        a, b, c, d = (inp + 2.0, inp + 3.0, inp + 5.0, inp + 7.0)
        return a, b, c, d

    return vdd(case, unpack, ref=lambda inp: (inp + 2.0, inp + 3.0, inp + 5.0, inp + 7.0))


TwelveFields = tuple[
    IField, IField, IField, IField, IField, IField,
    IField, IField, IField, IField, IField, IField,
]


@feature("tuples")
def tuple_unpacking_star_multi(case):
    @gtx.field_operator
    def unpack(inp: IField) -> TwelveFields:
        *a, a2, a3 = (inp, inp + 1.0, inp + 2.0, inp + 3.0)
        b1, *b, b3 = (inp + 4.0, inp + 5.0, inp + 6.0, inp + 7.0)
        c1, c2, *c = (inp + 8.0, inp + 9.0, inp + 10.0, inp + 11.0)
        return (a[0], a[1], a2, a3, b1, b[0], b[1], b3, c1, c2, c[0], c[1])

    return vdd(case, unpack, ref=lambda inp: tuple(inp + float(i) for i in range(12)))


@feature("tuples", raises=("DSLTypeError", "(?i)unpack"))
def tuple_unpacking_too_many_values(case):
    @gtx.field_operator
    def _star_unpack(inp: IField) -> IField:
        a, b, c = (inp, inp + 1.0, inp + 2.0, inp + 3.0)
        return a


@feature("tuples", raises=("DSLTypeError", "(?i)unpack"))
def tuple_unpacking_too_few_values(case):
    @gtx.field_operator
    def _invalid_unpack(inp: IField) -> IField:
        a, b, c = (inp, inp + 1.0)
        return a


# -- test_feature_where.py -----------------------------------------------------------------


@feature("where")
def where_k_offset(case):
    @gtx.field_operator
    def fieldop_where_k_offset(
        inp: gtx.Field[gtx.Dims[IDim, KDim], np.float64],
        k_index: gtx.Field[gtx.Dims[KDim], np.int64],
    ) -> gtx.Field[gtx.Dims[IDim, KDim], np.float64]:
        return where(k_index > 0, inp(Koff[-1]), 2.0)

    inp = cases.allocate(case, fieldop_where_k_offset, "inp")()
    k_index = cases.allocate(case, fieldop_where_k_offset, "k_index").index()()
    nk, ni = case.default_sizes[KDim], case.default_sizes[IDim]
    out = zeros({IDim: ni, KDim: (1, nk)})
    ref = np.where(k_index.asnumpy()[1:] > 0, inp.asnumpy()[:, :-1], 2.0)
    cases.verify(case, fieldop_where_k_offset, inp, k_index, out=out, ref=ref)
    return out


@feature("where")
def same_size_fields(case):
    @gtx.field_operator
    def testee(k: KField, interior: IJKField, boundary: IJKField) -> IJKField:
        return where(k == 0.0, boundary, interior)

    k = cases.allocate(case, testee, "k").index()()
    interior = cases.allocate(case, testee, "interior")()
    boundary = cases.allocate(case, testee, "boundary")()
    out = cases.allocate(case, testee, RETURN)()
    ref = np.where(k.asnumpy()[np.newaxis, np.newaxis, :] == 0, boundary.asnumpy(),
                   interior.asnumpy())
    cases.verify(case, testee, k, interior, boundary, out=out, ref=ref)
    return out


@feature("where")
def with_tuples(case):
    @gtx.field_operator
    def testee(
        k: KField,
        interior0: IJKField,
        interior1: IJKField,
        interior2: IJKField,
        boundary0: IJField,
        boundary1: IJField,
        boundary2: IJField,
    ) -> tuple[IJKField, tuple[IJKField, IJKField]]:
        return where(
            broadcast(k, (IDim, JDim, KDim)) == 0.0,
            (boundary0, (boundary1, boundary2)),
            (interior0, (interior1, interior2)),
        )

    k = cases.allocate(case, testee, "k").index()()
    interiors = tuple(cases.allocate(case, testee, f"interior{i}").unique()() for i in range(3))
    boundaries = tuple(cases.allocate(case, testee, f"boundary{i}").unique()() for i in range(3))
    out = cases.allocate(case, testee, RETURN)()
    refs = tuple(
        np.where(k.asnumpy()[np.newaxis, np.newaxis, :] == 0,
                 boundary.asnumpy()[:, :, np.newaxis], interior.asnumpy())
        for boundary, interior in zip(boundaries, interiors)
    )
    cases.verify(case, testee, k, *interiors, *boundaries, out=out,
                 ref=(refs[0], (refs[1], refs[2])))
    return out


@feature("where")
def conditional_nested_tuple(case):
    @gtx.field_operator
    def conditional_nested_tuple(
        mask: IBoolField, a: IField, b: IField
    ) -> tuple[tuple[IField, IField], tuple[IField, IField]]:
        return where(mask, ((a, b), (b, a)), ((5.0, 7.0), (7.0, 5.0)))

    size = case.default_sizes[IDim]
    mask = case.as_field([IDim], np.random.default_rng(3).random(size) > 0.5)
    a = cases.allocate(case, conditional_nested_tuple, "a").unique()()
    b = cases.allocate(case, conditional_nested_tuple, "b").unique()()
    w = functools.partial(np.where, mask.asnumpy())
    out = cases.allocate(case, conditional_nested_tuple, RETURN)()
    cases.verify(case, conditional_nested_tuple, mask, a, b, out=out, ref=(
        (w(a.asnumpy(), np.full(size, 5.0)), w(b.asnumpy(), np.full(size, 7.0))),
        (w(b.asnumpy(), np.full(size, 7.0)), w(a.asnumpy(), np.full(size, 5.0))),
    ))
    return out


@feature("where")
def conditional(case):
    @gtx.field_operator
    def conditional(mask: IBoolField, a: IField, b: IField) -> IField:
        return where(mask, a, b)

    size = case.default_sizes[IDim]
    mask = case.as_field([IDim], np.random.default_rng(4).random(size) > 0.5)
    a, b, out = _ab(case, conditional)
    cases.verify(case, conditional, mask, a, b, out=out,
                 ref=np.where(mask.asnumpy(), a.asnumpy(), b.asnumpy()))
    return out


@feature("where")
def conditional_scalar_promotion(case):
    @gtx.field_operator
    def conditional_promotion(mask: IBoolField, a: IField) -> IField:
        return where(mask, a, 10.0)

    size = case.default_sizes[IDim]
    mask = case.as_field([IDim], np.random.default_rng(5).random(size) > 0.5)
    a = cases.allocate(case, conditional_promotion, "a")()
    out = cases.allocate(case, conditional_promotion, RETURN)()
    cases.verify(case, conditional_promotion, mask, a, out=out,
                 ref=np.where(mask.asnumpy(), a.asnumpy(), 10.0))
    return out


@feature("where")
def conditional_compareop_mask(case):
    @gtx.field_operator
    def conditional_compare(a: IField) -> IField:
        return where(a != a, a, 10.0)

    return vdd(case, conditional_compare, ref=lambda a: np.where(a != a, a, 10.0))


@feature("where")
def conditional_shifted(case):
    @gtx.field_operator
    def conditional_shifted(mask: IBoolField, a: IField, b: IField) -> IField:
        tmp = where(mask, a, b)
        return tmp(IDim + 1)

    size = case.default_sizes[IDim]
    mask = case.as_field([IDim], np.random.default_rng(6).random(size + 1) > 0.5)
    a = cases.allocate(case, conditional_shifted, "a").extend({IDim: (0, 1)}).unique()()
    b = cases.allocate(case, conditional_shifted, "b").extend({IDim: (0, 1)}).unique()()
    out = zeros({IDim: size})
    cases.verify(case, conditional_shifted, mask, a, b, out=out,
                 ref=np.where(mask.asnumpy(), a.asnumpy(), b.asnumpy())[1:])
    return out


#: the cases whose every ``torch`` call with card fields is one CUDA graph
#: replay (captured at its first call)
CAPTURED = tuple(n for n in CASES if n not in RAISES and n not in NOT_CAPTURED)
