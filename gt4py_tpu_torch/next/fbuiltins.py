"""Field-operator builtins (reference: gt4py.next.ffront.fbuiltins,
src/gt4py/next/ffront/fbuiltins.py:254-433): neighbor reductions,
``broadcast``, ``where``, ``astype``, ``concat_where`` and the math
vocabulary, eagerly executable on embedded fields.

Counterpart of gt4py_tpu/next/fbuiltins.py. Each builtin dispatches on the
cartesian bridge's symbolic values (``SymNode``) first, as there. On torch
fields the types of the results follow the JAX package's promotion
(``embedded._promoted``); on NumPy fields (the ``numpy`` backend) NumPy
computes them, by its own rules, through the array's operation table
(``embedded.ops_of``).
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from gt4py_tpu_torch.core import ndarray_utils
from gt4py_tpu_torch.core.definitions import as_dtype, bfloat16 as _bf16, dtype_name, to_inexact
from gt4py_tpu_torch.core.ndarray_utils import torch_dtype
from gt4py_tpu_torch.next.common import Dimension, Domain, NamedRange, UnitRange
from gt4py_tpu_torch.next.embedded import (
    Bf16Array,
    Field,
    _np_cast,
    _Op,
    _promote_dims,
    bf16_apply,
    in_numpy_mode,
    ops_of,
)


def _is_sym(x) -> bool:
    return getattr(x, "_gt_symbolic_", False)


_NEUTRAL = {"sum": 0, "max": -np.inf, "min": np.inf}


def _neutral(op: str, dtype: np.dtype) -> Any:
    """The reduction's neutral element in ``dtype`` (integers: their
    extremes, where the JAX package casts an infinity)."""
    value = _NEUTRAL[op]
    if dtype.kind in "iub" and value != 0:
        if dtype.kind == "b":
            return value < 0
        info = np.iinfo(dtype)
        return info.min if value < 0 else info.max
    return value


def _reduce(field: Field, axis: Dimension, op: str) -> Field:
    if _is_sym(field):
        from gt4py_tpu_torch.next.cartesian_bridge import BridgeUnsupported

        raise BridgeUnsupported("neighbor reductions are unstructured")
    if not isinstance(field, Field):
        raise TypeError("neighbor reductions require a Field")
    ax = field.domain.index(axis)
    arr, ops = field.ndarray, field.ops
    new_domain = Domain(field.domain.ranges[:ax] + field.domain.ranges[ax + 1:])
    if field.mask is not None:
        fill = ops.scalar(_neutral(op, field.dtype), field.dtype, arr)
        arr = ops.where(field.mask, arr, fill)
    return Field(new_domain, ops.reduce(op, arr, ax))


def neighbor_sum(field: Field, axis: Dimension) -> Field:
    """Sum over a LOCAL neighbor dimension with skip-value masking
    (reference fbuiltins.py:255)."""
    return _reduce(field, axis, "sum")


def max_over(field: Field, axis: Dimension) -> Field:
    return _reduce(field, axis, "max")


def min_over(field: Field, axis: Dimension) -> Field:
    return _reduce(field, axis, "min")


def broadcast(value: Union[Field, Any], dims: tuple[Dimension, ...]) -> Field:
    """Mark a value as broadcastable over ``dims`` (reference
    fbuiltins.py:270). Embedded: unbounded placeholder ranges (size-1
    axes) get resolved by domain intersection in subsequent ops; a scalar
    becomes a field of weak type carrying the dim set."""
    if _is_sym(value):
        return value._builtin("broadcast", value)
    if isinstance(value, Field):
        new_dims = _promote_dims(value.dims, tuple(dims))
        ranges = []
        shape = []
        arr = value.ndarray
        for d in new_dims:
            if d in value.domain:
                ranges.append(value.domain[d])
                shape.append(len(value.domain[d].unit_range))
            else:
                ranges.append(NamedRange(d, UnitRange.infinite()))
                shape.append(1)
        perm = [value.domain.index(d) for d in new_dims if d in value.domain]
        if perm != sorted(perm):
            arr = value.ops.permute(arr, perm)
        return Field(Domain(tuple(ranges)), arr.reshape(shape), None, value.weak)
    weak = not isinstance(value, (torch.Tensor, np.ndarray, np.generic, bool))
    if isinstance(value, (torch.Tensor, np.ndarray)):
        arr = value
    elif in_numpy_mode():
        arr = np.asarray(value, dtype=_scalar_dtype(value))
    else:
        arr = torch.as_tensor(value, dtype=torch_dtype(_scalar_dtype(value)))
    domain = Domain(tuple(NamedRange(d, UnitRange.infinite()) for d in dims))
    return Field(domain, arr.reshape((1,) * len(dims)), None, weak)


def _scalar_dtype(value: Any) -> np.dtype:
    """The dtype a Python or NumPy scalar stands for (weak Python numbers:
    int64 and float64, as the JAX package's 64-bit mode makes them)."""
    if isinstance(value, np.generic):
        return value.dtype
    if isinstance(value, bool):
        return np.dtype(bool)
    if isinstance(value, int):
        return np.dtype(np.int64)
    return np.dtype(np.float64)


def where(cond: Field, a: Union[Field, Any], b: Union[Field, Any]) -> Field:
    """Ternary select (reference fbuiltins.py:281)."""
    if isinstance(a, tuple) or isinstance(b, tuple):
        # Tuple overload (reference fbuiltins.py:281): select element-wise
        # with the same condition.
        if not (isinstance(a, tuple) and isinstance(b, tuple) and len(a) == len(b)):
            raise TypeError("where: tuple branches must have matching structure")
        elts = [where(cond, x, y) for x, y in zip(a, b)]
        # Preserve NamedTuple carries (icon-like scan State pattern).
        return type(a)(*elts) if hasattr(a, "_fields") else tuple(elts)
    for x in (cond, a, b):
        if _is_sym(x):
            return x._builtin("where", cond, a, b)
    operands = [x for x in (cond, a, b) if isinstance(x, Field)]
    if not operands:
        # Raw values: plain element-wise select.
        if not any(isinstance(x, torch.Tensor) for x in (cond, a, b)):
            return np.where(cond, a, b)
        return ops_of(cond, a, b).select(cond, a, b, False, False)[0]
    dims = operands[0].dims
    for o in operands[1:]:
        dims = _promote_dims(dims, o.dims)

    # Align every operand onto the COMMON intersection domain of all
    # three (pairwise alignment misses narrowing imposed by the third
    # operand when all domains differ — reference
    # test_where_builtin_different_domain semantics).
    target = operands[0].domain
    for o in operands[1:]:
        target = target.intersection(o.domain)
    probe = Field.__new__(Field)
    probe.domain = target

    def align(x):
        if isinstance(x, Field):
            return x._aligned(dims, probe)
        return None, x

    dom_c, arr_c = align(cond)
    dom_a, arr_a = align(a)
    dom_b, arr_b = align(b)
    dom = dom_c or dom_a or dom_b
    weak = lambda x: x.weak if isinstance(x, Field) else False  # noqa: E731
    ops = ops_of(arr_c, arr_a, arr_b)
    result, is_weak = ops.select(arr_c, arr_a, arr_b, weak(a), weak(b))
    return Field(dom, result, None, is_weak)


def _np_dtype(dtype: Any) -> np.dtype:
    # identity checks: np.dtype('float64') == float is True in numpy
    if dtype is int or dtype is float or dtype is bool:
        return np.dtype({int: np.int64, float: np.float64, bool: np.bool_}[dtype])
    return ndarray_utils.numpy_dtype(dtype)


def astype(field: Union[Field, Any], dtype: Any) -> Field:
    if isinstance(field, tuple):
        # Tuple overload (reference fbuiltins.py:299): cast element-wise.
        return tuple(astype(f, dtype) for f in field)
    if _is_sym(field):
        return field._builtin("astype", field, dtype)
    np_dtype = _np_dtype(dtype)
    if isinstance(field, Field):
        return Field(field.domain, field.ops.astype(field.ndarray, np_dtype), field.mask)
    if isinstance(field, torch.Tensor) or (np_dtype == _bf16 and not in_numpy_mode()):
        return torch.as_tensor(field).to(torch_dtype(np_dtype))
    return _np_cast(np.asarray(field), np_dtype)


#: torch's functions for the math builtins, by the JAX package's names
_TORCH_NAMES = {
    "arcsin": "asin", "arccos": "acos", "arctan": "atan",
    "arcsinh": "asinh", "arccosh": "acosh", "arctanh": "atanh",
}
#: unary builtins that compute in a floating type (integers: JAX's
#: ``to_inexact``); the others keep the operand's type or give bool
_INEXACT = {
    "sin", "cos", "tan", "arcsin", "arccos", "arctan", "sinh", "cosh", "tanh",
    "arcsinh", "arccosh", "arctanh", "sqrt", "cbrt", "exp", "log", "gamma",
}


def _unary_impl(name: str):
    if name == "cbrt":
        return ndarray_utils._cbrt
    if name == "gamma":
        return ndarray_utils._gamma
    return getattr(torch, _TORCH_NAMES.get(name, name))


def _apply_unary(name: str, arr: torch.Tensor) -> torch.Tensor:
    if name in _INEXACT:
        dt = torch_dtype(to_inexact(ndarray_utils.numpy_dtype(arr.dtype)))
        arr = arr if arr.dtype == dt else arr.to(dt)
    elif name in ("floor", "ceil", "trunc") and not arr.dtype.is_floating_point:
        return arr.clone()
    return _unary_impl(name)(arr)


def _np_unary(name: str, arr: Any) -> Any:
    """The math builtin on a NumPy array, as NumPy computes it (``gamma``:
    SciPy's, as the JAX package's numpy path calls it)."""
    if name == "gamma":
        from scipy.special import gamma as _g

        if isinstance(arr, Bf16Array):
            return bf16_apply(_g, arr.view(np.ndarray)).view(Bf16Array)
        return _g(arr)
    return getattr(np, name)(arr)


def _field_unary(name: str):
    def fn(x):
        if _is_sym(x):
            return x._builtin(name, x)
        if isinstance(x, Field):
            if isinstance(x.ndarray, np.ndarray):
                return Field(x.domain, _np_unary(name, x.ndarray), x.mask)
            return Field(x.domain, _apply_unary(name, x.ndarray), x.mask)
        if isinstance(x, torch.Tensor):
            return _apply_unary(name, x)
        return _np_unary(name, x)

    fn.__name__ = name
    return fn


#: binary builtins: the JAX package's name -> torch's function
_BINARY = {
    "minimum": _Op(torch.minimum, tensors=True, np_fn=np.minimum),
    "maximum": _Op(torch.maximum, tensors=True, np_fn=np.maximum),
    "mod": _Op(torch.remainder, np_fn=np.mod),
    "power": _Op(torch.pow, tensors=True, np_fn=np.power),
}


def _field_binary(name: str):
    op = _BINARY[name]

    def fn(x, y):
        if _is_sym(x):
            return x._builtin(name, x, y)
        if _is_sym(y):
            return y._builtin(name, x, y)
        if isinstance(x, Field):
            return x._binary(y, op)
        if isinstance(y, Field):
            return y._rbinary(x, op)
        if not isinstance(x, torch.Tensor) and not isinstance(y, torch.Tensor):
            # plain scalars stay concrete (e.g. ``minimum(1, 2)`` feeding
            # a program ``domain=`` bound)
            return getattr(np, name)(x, y)
        return op(x, y)

    fn.__name__ = name
    return fn


abs = _field_unary("abs")  # noqa: A001
sin = _field_unary("sin")
cos = _field_unary("cos")
tan = _field_unary("tan")
arcsin = _field_unary("arcsin")
arccos = _field_unary("arccos")
arctan = _field_unary("arctan")
sinh = _field_unary("sinh")
cosh = _field_unary("cosh")
tanh = _field_unary("tanh")
arcsinh = _field_unary("arcsinh")
arccosh = _field_unary("arccosh")
arctanh = _field_unary("arctanh")
sqrt = _field_unary("sqrt")
cbrt = _field_unary("cbrt")
exp = _field_unary("exp")
log = _field_unary("log")
floor = _field_unary("floor")
ceil = _field_unary("ceil")
trunc = _field_unary("trunc")
isfinite = _field_unary("isfinite")
isinf = _field_unary("isinf")
isnan = _field_unary("isnan")
minimum = _field_binary("minimum")
maximum = _field_binary("maximum")
fmod = _field_binary("mod")
power = _field_binary("power")


def neg(x):
    """Unary negation as a function (reference fbuiltins.neg)."""
    return -x


#: the gamma function (reference fbuiltins.gamma / NativeFunction.GAMMA)
gamma = _field_unary("gamma")


MATH_BUILTIN_NAMES = [
    "abs", "sin", "cos", "tan", "arcsin", "arccos", "arctan", "sinh", "cosh",
    "tanh", "arcsinh", "arccosh", "arctanh", "sqrt", "cbrt", "exp", "log",
    "floor", "ceil", "trunc", "isfinite", "isinf", "isnan", "minimum",
    "maximum", "fmod", "power", "neg", "gamma",
]

# Scalar-kind aliases usable in DSL annotations (reference
# ffront/fbuiltins.py exports these at package level: gtx.float64 etc.).


class _TypeConstructor:
    """Dtype alias that is ALSO a constructor cast (reference type
    builtins: ``int64(inp)`` inside an operator casts the field,
    test_type_conversion.py). ``np.dtype()`` accepts it through the
    ``dtype`` attribute protocol, so it keeps working everywhere a dtype
    is expected (``zeros(..., dtype=gtx.float32)``, ``Field[Dims, ...]``
    annotations)."""

    __slots__ = ("np_type", "dtype")

    def __init__(self, np_type):
        self.np_type = np_type
        self.dtype = as_dtype(np_type)

    def __call__(self, x: Any) -> Any:
        if isinstance(x, (bool, int, float, str, np.generic)) and self.dtype.kind != "V":
            return self.np_type(x)
        return astype(x, self.dtype)

    @property
    def __name__(self) -> str:  # builtin-callable protocol (type deduction)
        return dtype_name(self.dtype)

    def __repr__(self) -> str:  # pragma: no cover — cosmetic
        return f"gt4py_tpu_torch.next.{self.__name__}"


bool_ = _TypeConstructor(np.bool_)
int8 = _TypeConstructor(np.int8)
int16 = _TypeConstructor(np.int16)
int32 = _TypeConstructor(np.int32)
int64 = _TypeConstructor(np.int64)
uint8 = _TypeConstructor(np.uint8)
uint16 = _TypeConstructor(np.uint16)
uint32 = _TypeConstructor(np.uint32)
uint64 = _TypeConstructor(np.uint64)
float32 = _TypeConstructor(np.float32)
float64 = _TypeConstructor(np.float64)
float16 = _TypeConstructor(np.float16)
# the port's bfloat16 token (core/definitions.py): a name for the type, the
# values live in torch.bfloat16 tensors
bfloat16 = _TypeConstructor(_bf16)

DTYPE_ALIAS_NAMES = [
    "bool_", "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64", "float32", "float64",
    "float16", "bfloat16",
]


def concat_where(cond, a, b) -> Field:
    """Domain-conditional concatenation (reference experimental
    ``concat_where``, ffront/experimental.py:52): select ``a`` where the
    per-dimension index condition holds (e.g. ``KDim < 1`` for surface
    boundary conditions), ``b`` elsewhere."""
    if isinstance(a, tuple) or isinstance(b, tuple):
        if not (isinstance(a, tuple) and isinstance(b, tuple) and len(a) == len(b)):
            raise TypeError("concat_where: tuple branches must have matching structure")
        return tuple(concat_where(cond, x, y) for x, y in zip(a, b))
    from gt4py_tpu_torch.next.common import DimCondition

    if not isinstance(cond, DimCondition):
        return where(cond, a, b)
    # Bridge tracing: lower to K-interval sections (straight-line
    # specialized code per vertical piece, cartesian_bridge.concat_k).
    sym = next((x for x in (a, b) if _is_sym(x)), None)
    if sym is not None:
        return sym._builtin("concat_where", cond, a, b)
    operands = [x for x in (a, b) if isinstance(x, Field)]
    if not operands:
        raise TypeError("concat_where requires at least one Field operand")
    dims = operands[0].dims
    for o in operands[1:]:
        dims = _promote_dims(dims, o.dims)
    if cond.dim not in dims:
        raise ValueError(f"Condition dimension {cond.dim} not in operands")

    # Reference semantics (nd_array_field.py:905 ``_concat_where``): the
    # result is the CONCATENATION along the condition dimension of the
    # true field restricted to the condition region(s) and the false
    # field restricted to the complement — each operand only needs to
    # cover its own region (boundary-condition idiom: the interior
    # branch may be shrunk by shifts). Orthogonal dims intersect.
    from gt4py_tpu_torch.next.common import complement_regions

    true_regions = cond.regions
    false_regions = complement_regions(true_regions)

    # Orthogonal intersection over operands that have the dim.
    ortho: dict = {}
    for d in dims:
        if d == cond.dim:
            continue
        rr = None
        for o in operands:
            if d in o.domain:
                orr = o.domain[d].unit_range
                rr = orr if rr is None else rr.intersection(orr)
        ortho[d] = rr if rr is not None else UnitRange.infinite()

    like = operands[0].ndarray
    ops = ops_of(*(o.ndarray for o in operands))
    result_dtype = ops.result_dtype(
        tuple(x.ndarray if isinstance(x, Field) else x for x in (a, b)),
        tuple(x.weak if isinstance(x, Field) else False for x in (a, b)),
    )

    # Bounding hull along the condition dim (finite operand ranges): a
    # scalar or dim-less contributor covers any region, clipped to the
    # hull so the result stays finite (the reference materializes an
    # infinite ConstantField instead; downstream the out write clips it —
    # reference test_concat_where_scalar_broadcast).
    hull = None
    for o in operands:
        if cond.dim in o.domain:
            orr = o.domain[cond.dim].unit_range
            if orr.is_finite:
                hull = (
                    orr
                    if hull is None
                    else UnitRange(min(hull.start, orr.start), max(hull.stop, orr.stop))
                )

    def contributions(x, regions):
        for reg in regions:
            if isinstance(x, Field) and cond.dim in x.domain and x.domain[
                cond.dim
            ].unit_range.is_finite:
                rr = x.domain[cond.dim].unit_range.intersection(reg)
            elif reg.is_finite:
                rr = reg  # scalar / dim-less branch on a bounded region
            elif hull is not None:
                rr = hull.intersection(reg)
            else:
                rr = reg
            if rr.is_empty():
                continue
            if not rr.is_finite:
                raise ValueError(
                    f"concat_where region {rr} along {cond.dim} is unbounded; "
                    "bound it with a field that has a finite range there"
                )
            yield rr, x

    pieces = sorted(
        [*contributions(a, true_regions), *contributions(b, false_regions)],
        key=lambda p: p[0].start,
    )
    if not pieces:
        raise ValueError("concat_where: no contributing region")
    for (r0, _), (r1, _) in zip(pieces, pieces[1:]):
        if r0.stop < r1.start:
            raise ValueError(
                f"concat_where: non-contiguous result domain along {cond.dim} "
                f"(gap between {r0} and {r1})"
            )
        if r0.stop > r1.start:  # pragma: no cover — regions are disjoint
            raise ValueError("concat_where: overlapping contributions")

    def piece_array(rr: "UnitRange", x) -> Any:
        target_ranges = tuple(
            NamedRange(d, rr if d == cond.dim else ortho[d]) for d in dims
        )
        shape = tuple(
            len(r.unit_range) if r.unit_range.is_finite else 1
            for r in target_ranges
        )
        if not isinstance(x, Field):
            return ops.full(shape, x, result_dtype, like)
        probe = Field.__new__(Field)
        probe.domain = Domain(target_ranges)
        _, arr = x._aligned(dims, probe)
        return ops.cast(ops.expand(arr, shape), result_dtype, like)

    arrays = [piece_array(rr, x) for rr, x in pieces]
    axis = list(dims).index(cond.dim)
    full_range = UnitRange(pieces[0][0].start, pieces[-1][0].stop)
    out_ranges = tuple(
        NamedRange(d, full_range if d == cond.dim else ortho[d]) for d in dims
    )
    return Field(
        Domain(out_ranges),
        arrays[0] if len(arrays) == 1 else ops.concat(arrays, axis),
    )

