"""GTScript DSL vocabulary and entry points.

Copied from gt4py_tpu/cartesian/gtscript.py; imports renamed.

Behavioral counterpart of the reference's ``gt4py.cartesian.gtscript``
(src/gt4py/cartesian/gtscript.py): axes ``I/J/K``, the
``Field``/``GlobalTable`` type descriptors, ``computation``/``interval``/
``horizontal``/``region`` context constructs, the math builtins, the
``@function`` helper and the ``stencil`` decorator.

Differences from the JAX package:

- the backends are ``"torch"`` (eager, any device) and ``"cuda:hopper"``
  (generated CUDA kernels, cartesian/backend/cuda_backend.py);
- math builtins are *callable* on NumPy arrays and torch tensors outside
  stencils, so the same definition function doubles as a reference
  implementation.
"""

from __future__ import annotations

import inspect
import math
import numbers
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np

from gt4py_tpu_torch.core.definitions import LITERAL_FLOAT_PRECISION, LITERAL_INT_PRECISION


# --- axes (reference: gtscript.py:622 Axis, :548 AxisIndex, :581 AxisInterval)


class ShiftedAxis:
    """An axis shifted by an offset, e.g. ``I + 1`` (reference gtscript.py:560)."""

    def __init__(self, name: str, shift: int):
        self.name = name
        self.shift = shift

    def __add__(self, shift: int) -> "ShiftedAxis":
        return ShiftedAxis(self.name, self.shift + shift)

    def __sub__(self, shift: int) -> "ShiftedAxis":
        return ShiftedAxis(self.name, self.shift - shift)

    def __repr__(self) -> str:
        return f"{self.name}{self.shift:+d}"


class AxisIndex:
    """Absolute position on an axis relative to the compute domain:
    non-negative = from the start, negative = from the end
    (reference gtscript.py:548)."""

    def __init__(self, axis: str, index: int, offset: int = 0):
        self.axis = axis
        self.index = index
        self.offset = offset

    def __add__(self, offset: int) -> "AxisIndex":
        return AxisIndex(self.axis, self.index, self.offset + offset)

    def __sub__(self, offset: int) -> "AxisIndex":
        return self.__add__(-offset)

    def __repr__(self) -> str:
        return f"{self.axis}[{self.index}]{self.offset:+d}"


class Axis:
    """Named cartesian axis (reference gtscript.py:622)."""

    def __init__(self, name: str):
        self.name = name

    def __getitem__(self, index: int) -> AxisIndex:
        if not isinstance(index, (int, np.integer)):
            raise TypeError(f"Axis index must be an integer, got {index!r}")
        return AxisIndex(self.name, int(index))

    def __add__(self, shift: int) -> ShiftedAxis:
        return ShiftedAxis(self.name, shift)

    def __sub__(self, shift: int) -> ShiftedAxis:
        return ShiftedAxis(self.name, -shift)

    def __repr__(self) -> str:
        return f"Axis({self.name})"


I = Axis("I")
J = Axis("J")
K = Axis("K")

IJ = (I, J)
IK = (I, K)
JK = (J, K)
IJK = (I, J, K)


# --- iteration order markers --------------------------------------------------

PARALLEL = "PARALLEL"
FORWARD = "FORWARD"
BACKWARD = "BACKWARD"


# --- Field / GlobalTable type descriptors ------------------------------------


class _FieldDescriptor:
    """Result of a ``Field[...]`` annotation (reference gtscript.py:696)."""

    def __init__(self, dtype: Any, axes: Sequence[Axis], data_dims: tuple[int, ...] = ()):
        self.dtype = dtype  # may be a string key resolved via the `dtypes` option
        self.axes = tuple(axes)
        self.data_dims = tuple(int(d) for d in data_dims)

    @property
    def dimensions_mask(self) -> tuple[bool, bool, bool]:
        names = [a.name for a in self.axes]
        return ("I" in names, "J" in names, "K" in names)

    def __repr__(self) -> str:
        axes = "".join(a.name for a in self.axes)
        dd = f", {self.data_dims}" if self.data_dims else ""
        return f"Field[{axes}, {self.dtype}{dd}]"


class _FieldDescriptorMaker:
    """Implements the ``Field[...]`` subscription grammar
    (reference gtscript.py:741-771):

    - ``Field[dtype]`` → IJK field
    - ``Field[axes, dtype]`` with axes in {I, J, K, IJ, IK, JK, IJK}
    - ``Field[(dtype, (n, ...))]`` → IJK field with data dimensions
    - ``Field[axes, (dtype, (n, ...))]``
    """

    def __getitem__(self, key: Any) -> _FieldDescriptor:
        axes: Sequence[Axis] = IJK
        dtype_spec = key
        if isinstance(key, tuple) and len(key) == 2 and self._is_axes_spec(key[0]):
            axes = key[0] if isinstance(key[0], tuple) else (key[0],)
            dtype_spec = key[1]
            names = [a.name for a in axes]
            if len(set(names)) != len(names):
                raise ValueError(
                    f"Field axes must not repeat (got {''.join(names)}); "
                    "reference gtscript.py rejects duplicated axes"
                )
            order = [n for n in "IJK" if n in names]
            if names != order:
                raise ValueError(
                    f"Field axes must be in I, J, K order (got {''.join(names)})"
                )
        data_dims: tuple[int, ...] = ()
        if isinstance(dtype_spec, tuple):
            if len(dtype_spec) != 2:
                raise ValueError(f"Invalid field dtype specification: {dtype_spec!r}")
            dtype, dims = dtype_spec
            data_dims = tuple(dims) if isinstance(dims, (tuple, list)) else (int(dims),)
        else:
            dtype = dtype_spec
        return _FieldDescriptor(dtype, axes, data_dims)

    @staticmethod
    def _is_axes_spec(value: Any) -> bool:
        return isinstance(value, Axis) or (
            isinstance(value, tuple) and value and all(isinstance(a, Axis) for a in value)
        )


Field = _FieldDescriptorMaker()


class _GlobalTableDescriptor:
    """Result of ``GlobalTable[(dtype, shape)]`` (reference gtscript.py:773)."""

    def __init__(self, dtype: Any, shape: tuple[int, ...]):
        self.dtype = dtype
        self.shape = tuple(int(s) for s in shape)

    def __repr__(self) -> str:
        return f"GlobalTable[{self.dtype}, {self.shape}]"


class _GlobalTableDescriptorMaker:
    def __getitem__(self, key: Any) -> _GlobalTableDescriptor:
        if not (isinstance(key, tuple) and len(key) == 2):
            raise ValueError(f"GlobalTable requires (dtype, shape), got {key!r}")
        dtype, shape = key
        return _GlobalTableDescriptor(dtype, tuple(shape))


GlobalTable = _GlobalTableDescriptorMaker()


# --- computation / interval / horizontal / region ----------------------------


class _ComputationContext:
    def __init__(self, order: str):
        if order not in (PARALLEL, FORWARD, BACKWARD):
            raise ValueError(f"Invalid computation order: {order!r}")
        self.order = order

    def __enter__(self):
        raise RuntimeError(
            "GTScript 'computation' blocks cannot be executed outside of a stencil definition"
        )

    def __exit__(self, *args):
        return False


class _IntervalContext:
    def __init__(self, start: Any, end: Any):
        self.start = start
        self.end = end

    def __enter__(self):
        raise RuntimeError(
            "GTScript 'interval' blocks cannot be executed outside of a stencil definition"
        )

    def __exit__(self, *args):
        return False


def computation(order: str) -> _ComputationContext:
    """Declare a vertical iteration policy (reference gtscript.py:821)."""
    return _ComputationContext(order)


def interval(*args: Any) -> _IntervalContext:
    """Declare a K interval relative to the compute domain
    (reference gtscript.py:826)."""
    if len(args) == 1:
        if args[0] is Ellipsis:
            return _IntervalContext(None, None)
        if isinstance(args[0], slice):
            return _IntervalContext(args[0].start, args[0].stop)
        raise ValueError(f"Invalid interval specification: {args!r}")
    if len(args) == 2:
        return _IntervalContext(args[0], args[1])
    raise ValueError(f"Invalid interval specification: {args!r}")


class _Region:
    """The ``region`` subscript helper building horizontal restriction masks
    (reference gtscript.py:836)."""

    def __getitem__(self, key: Any) -> "_RegionMask":
        if not isinstance(key, tuple):
            key = (key,)
        if len(key) != 2:
            raise ValueError("region[...] requires exactly two subscripts (I-range, J-range)")
        return _RegionMask(key[0], key[1])


class _RegionMask:
    def __init__(self, i_spec: Any, j_spec: Any):
        self.i_spec = i_spec
        self.j_spec = j_spec


region = _Region()


class _HorizontalContext:
    def __init__(self, masks: Sequence[_RegionMask]):
        self.masks = list(masks)

    def __enter__(self):
        raise RuntimeError(
            "GTScript 'horizontal' blocks cannot be executed outside of a stencil definition"
        )

    def __exit__(self, *args):
        return False


def horizontal(*masks: _RegionMask) -> _HorizontalContext:
    """Restrict execution of the body to horizontal sub-regions
    (reference gtscript.py:831)."""
    if not masks or not all(isinstance(m, _RegionMask) for m in masks):
        raise ValueError("horizontal(...) requires one or more region[...] arguments")
    return _HorizontalContext(masks)


# --- compile-time helpers -----------------------------------------------------


def __INLINED(expr: Any) -> Any:  # noqa: N807
    """Compile-time expression marker (reference gtscript.py:846). Outside a
    stencil it is the identity so definitions stay importable/executable."""
    return expr


def externals(*args):
    """Marker for inlined external values (reference gtscript.py:807) —
    usable at stencil module level to document/forward external names."""
    return args


def compile_assert(expr: Any) -> None:
    """Compile-time assertion (reference gtscript.py:851)."""
    if not expr:
        raise AssertionError("compile_assert failed")


# --- gtscript functions -------------------------------------------------------


def function(func: Callable) -> Callable:
    """Mark a function as an inlinable GTScript subroutine
    (reference gtscript.py:162). The returned object is still callable on
    array arguments (embedded/NumPy execution for validation)."""
    func._gtscript_function = True  # type: ignore[attr-defined]
    return func


def is_gtscript_function(obj: Any) -> bool:
    return callable(obj) and getattr(obj, "_gtscript_function", False)


# --- math builtins ------------------------------------------------------------
#
# Names and arities follow the reference's NativeFunction set
# (gtc/common.py:150-243 and gtscript.py:865-1030). Each builtin is a real
# callable dispatching to NumPy (host values) or torch (tensors) so stencil
# definitions remain plain Python functions usable as validation oracles.


def _dispatch_ns(x):
    if isinstance(x, (np.ndarray, np.generic, numbers.Number)):
        return np
    from gt4py_tpu_torch.core.ndarray_utils import torch_math

    return torch_math


class _MathBuiltin:
    def __init__(self, name: str, impl: Callable):
        self.name = name
        self.impl = impl
        self.__name__ = name

    def __call__(self, *args):
        return self.impl(*args)

    def __repr__(self) -> str:
        return f"<gtscript builtin {self.name}>"


def _special(name: str, scalar_fn: Callable) -> _MathBuiltin:
    """gamma/erf/erfc: math-module scalars on host values, torch on tensors."""

    def impl(x):
        ns = _dispatch_ns(x)
        if ns is np:
            out = np.vectorize(scalar_fn)(x)
            return out if isinstance(x, np.ndarray) else float(out)
        return getattr(ns, name)(x)

    return _MathBuiltin(name, impl)


def _round_away_from_zero(x):
    ns = _dispatch_ns(x)
    if ns is np:
        return np.trunc(x + np.copysign(0.5, x))
    return ns.round_away_from_zero(x)


def _make_unary(name: str, np_name: Optional[str] = None) -> _MathBuiltin:
    np_name = np_name or name

    def impl(x):
        ns = _dispatch_ns(x)
        return getattr(ns, np_name)(x)

    return _MathBuiltin(name, impl)


def _make_binary(name: str, np_name: Optional[str] = None) -> _MathBuiltin:
    np_name = np_name or name

    def impl(x, y):
        ns = _dispatch_ns(x)
        return getattr(ns, np_name)(x, y)

    return _MathBuiltin(name, impl)


sin = _make_unary("sin")
cos = _make_unary("cos")
tan = _make_unary("tan")
asin = _make_unary("asin", "arcsin")
acos = _make_unary("acos", "arccos")
atan = _make_unary("atan", "arctan")
sinh = _make_unary("sinh")
cosh = _make_unary("cosh")
tanh = _make_unary("tanh")
asinh = _make_unary("asinh", "arcsinh")
acosh = _make_unary("acosh", "arccosh")
atanh = _make_unary("atanh", "arctanh")
sqrt = _make_unary("sqrt")
cbrt = _make_unary("cbrt")
exp = _make_unary("exp")
log = _make_unary("log")
log10 = _make_unary("log10")
floor = _make_unary("floor")
ceil = _make_unary("ceil")
trunc = _make_unary("trunc")
isfinite = _make_unary("isfinite")
isinf = _make_unary("isinf")
isnan = _make_unary("isnan")
mod = _make_binary("mod")
atan2 = _make_binary("atan2", "arctan2")
hypot = _make_binary("hypot")
copysign = _make_binary("copysign")
round = _MathBuiltin("round", lambda x: _dispatch_ns(x).round(x))
round_away_from_zero = _MathBuiltin("round_away_from_zero", _round_away_from_zero)
gamma = _special("gamma", math.gamma)
erf = _special("erf", math.erf)
erfc = _special("erfc", math.erfc)
fma = _MathBuiltin("fma", lambda a, b, c: a * b + c)

MATH_BUILTINS: dict[str, _MathBuiltin] = {
    b.name: b
    for b in [
        sin, cos, tan, asin, acos, atan, sinh, cosh, tanh, asinh, acosh, atanh,
        sqrt, cbrt, exp, log, log10, floor, ceil, trunc, isfinite, isinf, isnan,
        mod, atan2, hypot, copysign, round, round_away_from_zero, gamma, erf,
        erfc, fma,
    ]
}

# Python builtins understood inside stencils, mapped to NativeFunctions.
PYTHON_BUILTIN_FUNCS = {"abs": "abs", "min": "min", "max": "max"}


# --- stencil decorator --------------------------------------------------------

#: extra per-backend options accepted by ``stencil(**kwargs)``; anything
#: else is a loud error (typos must not silently change semantics).
SUPPORTED_BACKEND_OPTS = frozenset(
    {"inline_temporaries", "fuse_sequential", "pass_pipeline"}
)


def stencil(
    backend: Optional[str] = None,
    definition: Optional[Callable] = None,
    *,
    build_info: Optional[dict] = None,
    dtypes: Optional[dict] = None,
    externals: Optional[dict] = None,
    format_source: bool = True,
    name: Optional[str] = None,
    rebuild: bool = False,
    cache_settings: Optional[dict] = None,
    raise_if_not_cached: bool = False,
    literal_int_precision: int = LITERAL_INT_PRECISION,
    literal_float_precision: int = LITERAL_FLOAT_PRECISION,
    **kwargs: Any,
):
    """Compile a stencil definition for ``backend``; usable as a decorator or
    a plain function (API parity with reference gtscript.py:210).

    Supported backends: ``"torch"`` (eager torch on the tensors' device,
    the plain version of every kernel) and ``"cuda:hopper"`` (generated
    CUDA kernels for the H100, counterpart of ``tpu:pallas``).
    """
    from gt4py_tpu_torch.cartesian import loader

    if build_info is not None and not isinstance(build_info, dict):
        raise ValueError(f"Invalid 'build_info' dictionary ('{build_info}')")
    if dtypes is not None and not isinstance(dtypes, dict):
        raise ValueError(f"Invalid 'dtypes' dictionary ('{dtypes}')")
    if externals is not None and not isinstance(externals, dict):
        raise ValueError(f"Invalid 'externals' dictionary ('{externals}')")
    if name is not None and not isinstance(name, str):
        raise ValueError(f"Invalid 'name' string ('{name}')")
    if not isinstance(rebuild, bool):
        raise ValueError(f"Invalid 'rebuild' bool value ('{rebuild}')")
    # Unknown extra kwargs are rejected loudly: they would otherwise become
    # silently-ignored backend options (reference validates backend_opts
    # against Backend.options, backend/base.py:75).
    unknown = set(kwargs) - SUPPORTED_BACKEND_OPTS
    if unknown:
        import difflib

        all_names = sorted(
            SUPPORTED_BACKEND_OPTS
            | {
                "backend", "definition", "build_info", "dtypes", "externals",
                "format_source", "name", "rebuild", "cache_settings",
                "raise_if_not_cached", "literal_int_precision",
                "literal_float_precision",
            }
        )
        hints = []
        for k in sorted(unknown):
            close = difflib.get_close_matches(k, all_names, n=1)
            hints.append(f"'{k}'" + (f" (did you mean '{close[0]}'?)" if close else ""))
        raise ValueError(
            f"Unknown stencil option(s): {', '.join(hints)}. "
            f"Supported backend options: {sorted(SUPPORTED_BACKEND_OPTS)}"
        )

    build_options = dict(
        backend=backend or "torch",
        build_info=build_info,
        dtypes=dtypes or {},
        externals=externals or {},
        name=name,
        rebuild=rebuild,
        format_source=format_source,
        cache_settings=cache_settings or {},
        raise_if_not_cached=raise_if_not_cached,
        literal_int_precision=literal_int_precision,
        literal_float_precision=literal_float_precision,
        backend_opts=kwargs,
    )

    def _decorator(func: Callable):
        return loader.load_stencil(func, build_options)

    if definition is None:
        return _decorator
    return _decorator(definition)


def lazy_stencil(
    backend: Optional[str] = None,
    definition: Optional[Callable] = None,
    *,
    eager: bool = False,
    check_syntax: bool = True,
    **kwargs: Any,
):
    """Deferred-build stencil wrapper (reference gtscript.py:394): the
    stencil is built on first use; with ``check_syntax`` the frontend runs
    immediately to report DSL errors early."""
    from gt4py_tpu_torch.cartesian.lazy_stencil import LazyStencil

    def _decorator(func: Callable):
        lazy = LazyStencil(func, backend=backend or "torch", build_options=kwargs)
        if check_syntax:
            lazy.check_syntax()
        return lazy.implementation if eager else lazy

    if definition is None:
        return _decorator
    return _decorator(definition)


def stencil_definition_signature(func: Callable) -> inspect.Signature:
    return inspect.signature(func)
