"""Embedded field implementation on torch tensors.

Counterpart of gt4py_tpu/next/embedded.py (and of the reference's
``gt4py.next.embedded`` + ``nd_array_field.py``). It is the plain version
of every field-view operator: the ``torch`` backend runs on it, and the
``cuda:hopper`` backend runs on it whatever the cartesian bridge does not
take. Differences from the JAX package:

- a Field holds a torch tensor, on the device the tensor lives on;
  nothing is moved between devices;
- arithmetic promotes as the JAX package does (JAX's lattice with weak
  Python scalars and 64-bit types, ``core.definitions.promote_types``),
  not by torch's rules; a Field made from a Python scalar
  (``broadcast(0.0, dims)``) keeps the scalar's weak type;
- a remap through a connectivity is one gather with ``skip_value``
  masking. The JAX package's roll plans, fix-up scatters, lazy neighbour
  parts and row gathers exist because row gathers are slow on the TPU, and
  are not ported;
- restriction is a view of the base tensor, so writing into
  ``out=field[:, 1:]`` writes the base field: no write-back link.

A Field may also hold a NumPy array: the ``numpy`` backend's oracle (the
JAX package's ``_xp``, embedded.py:87). Every operation takes its
namespace from the array, through one small table (:class:`_TorchOps`,
:class:`_NumpyOps`), and a NumPy Field computes by NumPy's own rules, as
the JAX package's ``numpy`` backend applies NumPy's operators: NumPy 2's
promotion, Python scalars and Fields of weak type adapting to the other
operand (NEP 50). bfloat16 is carried in float32 and rounded after every
operation (``numpy_evaluator.round_bf16``), as ml_dtypes computes it.
"""

from __future__ import annotations

import contextvars
import dataclasses
import operator
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from gt4py_tpu_torch.cartesian.backend.numpy_evaluator import (
    bf16_apply,
    carrier_dtype,
    round_bf16,
)
from gt4py_tpu_torch.core.definitions import (
    WEAK_FLOAT,
    WEAK_INT,
    as_dtype,
    bfloat16,
    promote_types,
    to_inexact,
)
from gt4py_tpu_torch.core.ndarray_utils import asnumpy, numpy_dtype, torch_dtype
from gt4py_tpu_torch.next.common import (
    Connectivity,
    Dimension,
    Domain,
    FieldOffset,
    NamedRange,
    OffsetIndex,
    UnitRange,
)

# offset_provider for the current field-operator call (reference:
# embedded/context.py).
_OFFSET_PROVIDER: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "offset_provider", default=None
)


def current_offset_provider() -> dict:
    value = _OFFSET_PROVIDER.get()
    if value is None:
        raise RuntimeError(
            "No offset_provider in context — pass offset_provider={...} to the "
            "field operator / program call"
        )
    return value


class offset_provider_context:
    def __init__(self, provider: Optional[dict]):
        # None inherits the ambient provider: an operator called inside a
        # program (or another operator) without its own offset_provider
        # keeps the program's. An explicit {} still clears.
        if provider is None:
            provider = _OFFSET_PROVIDER.get() or {}
        self.provider = provider

    def __enter__(self):
        self._token = _OFFSET_PROVIDER.set(self.provider)
        return self

    def __exit__(self, *args):
        _OFFSET_PROVIDER.reset(self._token)
        return False


# The array namespace of Fields made from no array (``broadcast(1.0,
# dims)``, a scan without Field arguments): NumPy inside a call of the
# ``numpy`` backend, torch otherwise.
_NUMPY_MODE: contextvars.ContextVar[bool] = contextvars.ContextVar("numpy_mode", default=False)


class numpy_mode:
    """Within this context, Fields made from no array hold NumPy arrays."""

    def __enter__(self):
        self._token = _NUMPY_MODE.set(True)
        return self

    def __exit__(self, *args):
        _NUMPY_MODE.reset(self._token)
        return False


def in_numpy_mode() -> bool:
    return _NUMPY_MODE.get()


def _promote_dims(a: tuple[Dimension, ...], b: tuple[Dimension, ...]) -> tuple[Dimension, ...]:
    """Union of dims preserving relative order (reference common.py:1367)."""
    result = list(a)
    for d in b:
        if d not in result:
            # Insert respecting b's order relative to dims already present.
            later = [x for x in b[b.index(d) + 1:] if x in result]
            if later:
                idx = min(result.index(x) for x in later)
                result.insert(idx, d)
            else:
                result.append(d)
    return tuple(result)


# -- promotion ----------------------------------------------------------------


def _type_of(value: Any, weak: bool = False) -> Any:
    """The promotion type of an operand: a tensor's dtype (:data:`WEAK_INT`
    or :data:`WEAK_FLOAT` where ``weak``), a NumPy scalar's dtype, or the
    weak type of a Python number."""
    if isinstance(value, torch.Tensor):
        dt = numpy_dtype(value.dtype)
        if weak and dt.kind in "iuf":
            return WEAK_FLOAT if dt.kind == "f" else WEAK_INT
        return dt
    if isinstance(value, (bool, np.bool_)):
        return np.dtype(bool)
    if isinstance(value, np.generic):
        return value.dtype
    if isinstance(value, int):
        return WEAK_INT
    if isinstance(value, float):
        return WEAK_FLOAT
    raise TypeError(f"unsupported field operand {type(value).__name__}")


def _promoted(values: tuple, weaks: tuple, inexact: bool = False) -> tuple:
    """``(values cast to their JAX result type, that torch dtype, whether the
    result is weak)``. Tensors are cast; NumPy scalars become Python
    numbers of the same value (the result type already holds them); Python
    numbers stay, so torch computes them in the tensors' type."""
    dt, weak = promote_types(*(_type_of(v, w) for v, w in zip(values, weaks)))
    if inexact:
        dt = to_inexact(dt)
    tdt = torch_dtype(dt)
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v if v.dtype == tdt else v.to(tdt))
        elif isinstance(v, np.generic):
            out.append(v.item())
        else:
            out.append(v)
    return tuple(out), tdt, weak


def _is_operand(value: Any) -> bool:
    """Whether a Field operator takes ``value`` as its other operand."""
    return isinstance(value, (Field, torch.Tensor, np.ndarray, np.generic, int, float))


def _one_value(t: torch.Tensor) -> bool:
    """Whether ``t`` holds one value: one element, or one expanded."""
    return t.numel() == 1 or (t.numel() > 0 and not any(t.stride()))


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``. A host tensor of one value (a broadcast scalar)
    becomes a fill on the device, its value read on the host: no copy from
    the host, which a CUDA graph's capture refuses (it synchronises)."""
    if t.device == device:
        return t
    if t.device.type == "cpu" and _one_value(t):
        return torch.full(t.shape, t[(0,) * t.dim()].item(), dtype=t.dtype, device=device)
    return t.to(device)


def _same_device(a: Any, b: Any) -> tuple:
    """Move a tensor of one value (a broadcast scalar) to the other
    operand's device, a host one first (:func:`to_device`); tensors of
    several values must share one."""
    if (
        isinstance(a, torch.Tensor)
        and isinstance(b, torch.Tensor)
        and a.device != b.device
    ):
        if _one_value(a) and (a.device.type == "cpu" or not _one_value(b)):
            a = to_device(a, b.device)
        elif _one_value(b):
            b = to_device(b, a.device)
    return a, b


def scalar_tensor(v: Any, dtype: torch.dtype, device: Optional[torch.device]) -> torch.Tensor:
    """The number ``v`` as a 0-d tensor of ``dtype`` on ``device``, converted
    on the host as ``torch.as_tensor`` converts it (overflow to inf
    included) and written on a card by a fill: no copy from the host."""
    t = torch.as_tensor(v, dtype=dtype)
    if device is None or device.type == "cpu":
        return t
    return torch.full((), t.item(), dtype=dtype, device=device)


def _as_tensor(v: Any, dtype: torch.dtype, like: Any) -> torch.Tensor:
    """``v`` as a tensor of ``dtype`` on the device of ``like`` (for torch
    functions that take no Python number)."""
    if isinstance(v, torch.Tensor):
        return v
    return scalar_tensor(v, dtype, like.device if isinstance(like, torch.Tensor) else None)


# -- bfloat16 on NumPy --------------------------------------------------------------

#: dtypes whose operations with bfloat16 give bfloat16 in ml_dtypes
_BF16_PARTNERS = (np.dtype(np.bool_), np.dtype(np.int8), np.dtype(np.uint8))


class Bf16Array(np.ndarray):
    """bfloat16 values carried in a float32 array (NumPy has no bfloat16).
    A ufunc whose ml_dtypes result is bfloat16 (every operand bfloat16, a
    Python bool or a type narrower than it) computes as
    ``numpy_evaluator.bf16_apply`` does — in float64, rounded to float32,
    then to bfloat16 — and gives a Bf16Array; any other ufunc runs on the
    float32 values, as ml_dtypes promotes bfloat16 with a Python number or
    a wider type (to float32 or past it). Views (slices, reshapes,
    transposes) stay Bf16Arrays."""

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if kwargs.get("out") is not None:
            raise TypeError("a bfloat16 carrier takes no out= argument")
        plain = [x.view(np.ndarray) if isinstance(x, Bf16Array) else x for x in inputs]
        bf16 = all(_bf16_partner(x) for x in inputs)
        if method == "reduce" and bf16 and ufunc is np.add:
            # ml_dtypes adds level after level, rounding every partial sum
            axis = kwargs.get("axis", 0)
            parts = np.moveaxis(plain[0], axis, 0)
            total = parts[0]
            for part in parts[1:]:
                total = bf16_apply(np.add, total, part)
            return as_bf16(total)
        result = getattr(ufunc, method)(*plain, **kwargs)
        if not bf16 or np.asarray(result).dtype.kind != "f":
            return result
        if method == "__call__":
            result = bf16_apply(ufunc, *plain)
        return as_bf16(result)


def _bf16_partner(x: Any) -> bool:
    """Whether ml_dtypes keeps bfloat16 beside ``x``."""
    if isinstance(x, (Bf16Array, bool)):
        return True
    return isinstance(x, (np.ndarray, np.generic)) and x.dtype in _BF16_PARTNERS


def as_bf16(values: Any) -> Bf16Array:
    """``values`` rounded to bfloat16, as a :class:`Bf16Array`."""
    return np.asarray(round_bf16(np.asarray(values, dtype=np.float32))).view(Bf16Array)


def _np_dtype_of(arr: Any) -> np.dtype:
    """The dtype a NumPy value stands for: bfloat16 for a carrier."""
    return bfloat16 if isinstance(arr, Bf16Array) else np.asarray(arr).dtype


def _np_cast(arr: Any, dtype: Any) -> Any:
    """``arr`` as ``dtype``, bfloat16 as a rounded carrier."""
    dt = as_dtype(dtype)
    if dt == bfloat16:
        return arr if isinstance(arr, Bf16Array) else as_bf16(arr)
    if isinstance(arr, Bf16Array):
        arr = arr.view(np.ndarray)
    return arr if arr.dtype == dt else arr.astype(dt)


def _stand_in(arr: Any) -> Any:
    """The Python scalar a weak NumPy array promotes as (NEP 50)."""
    kind = _np_dtype_of(arr).kind
    return 0.0 if kind in "fV" else (False if kind == "b" else 0)


def _np_weak(value: Any, weak: bool, other: Any, other_weak: bool) -> Any:
    """A weak NumPy operand cast to the type NumPy gives a Python scalar
    beside ``other`` (NEP 50); strong operands and a pair of weak ones
    stay as they are."""
    if not weak or other_weak or not isinstance(value, np.ndarray):
        return value
    if isinstance(other, np.ndarray):
        dt = _np_dtype_of(other)
        if dt == bfloat16:
            return _np_cast(value, bfloat16)
        other = np.empty((), dt)
    if not isinstance(other, (np.ndarray, np.generic)):
        return value
    return _np_cast(value, np.result_type(other, _stand_in(value)))


def device_index(conn, device: torch.device) -> torch.Tensor:
    """``conn.table`` as int64 indices on ``device``, cast once and kept on
    the connectivity, by device, with the table it was cast from, for as
    long as ``conn.table`` is that tensor, unmodified (its version
    counter): a rebound or rewritten table is cast anew. A cast made while
    a CUDA graph captures is not kept (what a capture allocates must not
    outlive it). A CUDA graph that reads an index keeps it alive
    (``otf.Graph``)."""
    table = conn.table
    cache = conn.__dict__.setdefault("_gt_index", {})
    hit = cache.get(device)
    if hit is not None and hit[0] is table and hit[1] == table._version:
        return hit[2]
    idx = table.to(device).to(torch.int64)
    if device.type == "cpu" or not torch.cuda.is_current_stream_capturing():
        cache[device] = (table, table._version, idx)
    return idx


class _TorchOps:
    """A Field's array operations on torch tensors, with the JAX package's
    promotion (:func:`_promoted`)."""

    def binary(self, op: "_Op", a: Any, b: Any, wa: bool, wb: bool) -> tuple:
        """``(op(a, b), whether the result is weak)``."""
        a, b = _same_device(a, b)
        if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
            return op.fn(a, b), False
        (a, b), tdt, weak = _promoted((a, b), (wa, wb), op.inexact)
        if op.tensors:
            like = a if isinstance(a, torch.Tensor) else b
            a, b = _as_tensor(a, tdt, like), _as_tensor(b, tdt, like)
        return op.fn(a, b), weak and not op.compare

    def select(self, cond: Any, a: Any, b: Any, wa: bool, wb: bool) -> tuple:
        """``(where(cond, a, b), weak)``, the branches promoted."""
        a, b = _same_device(a, b)
        if isinstance(cond, torch.Tensor):
            cond, a = _same_device(cond, a)
            cond, b = _same_device(cond, b)
        (a, b), tdt, weak = _promoted((a, b), (wa, wb))
        like = cond if isinstance(cond, torch.Tensor) else (a if isinstance(a, torch.Tensor) else b)
        a, b = _as_tensor(a, tdt, like), _as_tensor(b, tdt, like)
        cond = _as_tensor(cond, torch.bool, a)
        return torch.where(cond, a, b), weak

    def result_dtype(self, values: tuple, weaks: tuple) -> torch.dtype:
        return _promoted(values, weaks)[1]

    def take_along(self, arr, idx, axis: int):
        return torch.take_along_dim(arr, idx, dim=axis)

    def gather(self, arr, axis: int, idx):
        return torch.index_select(arr, axis, idx)

    def index(self, conn, column: Optional[int], like):
        """A connectivity's table (its ``column``-th column, a view) as int64
        indices on ``like``'s device (:func:`device_index`)."""
        idx = device_index(conn, like.device)
        return idx if column is None else idx[:, column]

    def arange(self, n: int, like):
        return torch.arange(n, device=like.device)

    def as_int(self, arr, like):
        return arr.to(device=like.device, dtype=torch.int64)

    def clip(self, arr, lo: int, hi: int):
        return arr.clamp(lo, hi)

    def permute(self, arr, perm):
        return arr.permute(perm)

    def unsqueeze(self, arr, axis: int):
        return arr.unsqueeze(axis)

    def expand(self, arr, shape):
        return arr.expand(shape)

    def take_index(self, arr, axis: int, index: int):
        return arr.select(axis, index)

    def where(self, cond, a, b):
        return torch.where(cond, a, b)

    def scalar(self, value: Any, dtype: np.dtype, like):
        return scalar_tensor(value, torch_dtype(dtype), like.device)

    def full(self, shape, value: Any, dtype, like):
        value = value.item() if isinstance(value, np.generic) else value
        return torch.full(shape, value, dtype=dtype, device=like.device)

    def cast(self, arr, dtype, like):
        return arr.to(device=like.device, dtype=dtype)

    def concat(self, arrays, axis: int):
        return torch.cat(arrays, dim=axis)

    def reduce(self, name: str, arr, axis: int):
        if name == "sum":
            return torch.sum(arr, dim=axis)
        return (torch.amax if name == "max" else torch.amin)(arr, dim=axis)

    def astype(self, arr, dtype):
        return arr.to(torch_dtype(dtype))

    logical_and = staticmethod(torch.logical_and)
    logical_not = staticmethod(torch.logical_not)
    abs = staticmethod(torch.abs)


class _NumpyOps:
    """A Field's array operations on NumPy arrays, with NumPy's promotion:
    what the JAX package's ``numpy`` backend computes (its ``_xp`` is
    NumPy there). A weak operand (a Field made from a Python scalar)
    promotes as the Python scalar does (NEP 50)."""

    def binary(self, op: "_Op", a: Any, b: Any, wa: bool, wb: bool) -> tuple:
        a, b = _np_weak(a, wa, b, wb), _np_weak(b, wb, a, wa)
        return op.np_fn(a, b), wa and wb and not op.compare

    def select(self, cond: Any, a: Any, b: Any, wa: bool, wb: bool) -> tuple:
        a, b = _np_weak(a, wa, b, wb), _np_weak(b, wb, a, wa)
        if isinstance(a, Bf16Array) or isinstance(b, Bf16Array):
            if _bf16_partner(a) and _bf16_partner(b):
                return as_bf16(np.where(cond, a, b)), wa and wb
            # ml_dtypes takes a Python number beside bfloat16 as float64
            a, b = (
                np.asarray(x, np.float64) if isinstance(x, (int, float)) else
                x.view(np.ndarray) if isinstance(x, Bf16Array) else x
                for x in (a, b)
            )
        return np.where(cond, a, b), wa and wb

    def result_dtype(self, values: tuple, weaks: tuple) -> np.dtype:
        dts = [_np_dtype_of(v) for v, w in zip(values, weaks) if isinstance(v, np.ndarray) and not w]
        if bfloat16 in dts:
            return bfloat16
        scalars = [
            v.item() if isinstance(v, np.ndarray) else v
            for v, w in zip(values, weaks)
            if not isinstance(v, np.ndarray) or w
        ]
        return np.result_type(*dts, *scalars)

    def take_along(self, arr, idx, axis: int):
        return _keep_bf16(arr, np.take_along_axis(arr.view(np.ndarray), idx, axis=axis))

    def gather(self, arr, axis: int, idx):
        return _keep_bf16(arr, np.take(arr.view(np.ndarray), idx, axis=axis))

    def index(self, conn, column: Optional[int], like):
        table = conn.table if column is None else conn.table[:, column]
        return asnumpy(table).astype(np.int64)

    def arange(self, n: int, like):
        return np.arange(n, dtype=np.int32)

    def as_int(self, arr, like):
        return np.asarray(arr).astype(np.int32)

    def clip(self, arr, lo: int, hi: int):
        return np.clip(arr, lo, hi)

    def permute(self, arr, perm):
        return arr.transpose(perm)

    def unsqueeze(self, arr, axis: int):
        return np.expand_dims(arr, axis)

    def expand(self, arr, shape):
        return np.broadcast_to(arr, shape, subok=True)

    def take_index(self, arr, axis: int, index: int):
        return np.take(arr, index, axis=axis)

    def where(self, cond, a, b):
        return np.where(cond, a, b)

    def scalar(self, value: Any, dtype: np.dtype, like):
        return _np_cast(np.asarray(value, dtype=carrier_dtype(dtype)), dtype)

    def full(self, shape, value: Any, dtype, like):
        return _np_cast(np.full(shape, value, dtype=carrier_dtype(dtype)), dtype)

    def cast(self, arr, dtype, like):
        return _np_cast(arr, dtype)

    def concat(self, arrays, axis: int):
        return _keep_bf16(arrays[0], np.concatenate(arrays, axis=axis))

    def reduce(self, name: str, arr, axis: int):
        return getattr(np, name)(arr, axis=axis)

    def astype(self, arr, dtype):
        return _np_cast(arr, dtype)

    logical_and = staticmethod(np.logical_and)
    logical_not = staticmethod(np.logical_not)
    abs = staticmethod(np.abs)


def _keep_bf16(source: Any, result: np.ndarray) -> np.ndarray:
    """``result`` (values selected from ``source``) as a carrier where
    ``source`` is one."""
    return result.view(Bf16Array) if isinstance(source, Bf16Array) else result


TORCH_OPS = _TorchOps()
NUMPY_OPS = _NumpyOps()


def ops_of(*values: Any):
    """The operation table of the arrays among ``values``: NumPy's where
    one is a NumPy array, torch's otherwise."""
    if any(isinstance(v, np.ndarray) for v in values):
        return NUMPY_OPS
    if any(isinstance(v, torch.Tensor) for v in values):
        return TORCH_OPS
    return NUMPY_OPS if in_numpy_mode() else TORCH_OPS


def as_numpy_array(value: Any) -> Any:
    """A tensor as NumPy for a NumPy Field: a view of a CPU tensor (a
    bfloat16 one as a rounded float32 carrier, a copy); a tensor on a card
    raises, since nothing is moved between devices."""
    if not isinstance(value, torch.Tensor):
        return value
    if value.device.type != "cpu":
        raise TypeError(
            f"the numpy backend runs on the host: a tensor on {value.device} cannot be "
            "handed to it (nothing is moved between devices)"
        )
    if value.dtype == torch.bfloat16:
        return as_bf16(value.float().numpy())
    return value.detach().numpy()


class _Op:
    """A binary array operation: ``fn`` on tensors, with the JAX package's
    promotion (the operands are cast to their JAX result type, its floating
    type where ``inexact``; ``tensors``: ``fn`` takes tensors only), and
    ``np_fn`` on NumPy arrays, with NumPy's. ``compare``: the result is
    bool (never weak)."""

    __slots__ = ("fn", "np_fn", "inexact", "tensors", "compare")

    def __init__(self, fn: Callable, inexact=False, tensors=False, compare=False, np_fn=None):
        self.fn = fn
        self.np_fn = np_fn or fn
        self.inexact = inexact
        self.tensors = tensors
        self.compare = compare

    def apply(self, a: Any, b: Any, wa: bool = False, wb: bool = False) -> tuple:
        """``(result, weak)``."""
        return ops_of(a, b).binary(self, a, b, wa, wb)

    def __call__(self, a: Any, b: Any) -> Any:
        return self.apply(a, b)[0]


ADD = _Op(operator.add)
SUB = _Op(operator.sub)
MUL = _Op(operator.mul)
TRUEDIV = _Op(operator.truediv, inexact=True)
POW = _Op(operator.pow)
MOD = _Op(operator.mod)
FLOORDIV = _Op(operator.floordiv)
EQ = _Op(operator.eq, compare=True)
NE = _Op(operator.ne, compare=True)
LT = _Op(operator.lt, compare=True)
LE = _Op(operator.le, compare=True)
GT = _Op(operator.gt, compare=True)
GE = _Op(operator.ge, compare=True)
LOGICAL_AND = _Op(torch.logical_and, tensors=True, compare=True, np_fn=np.logical_and)
LOGICAL_OR = _Op(torch.logical_or, tensors=True, compare=True, np_fn=np.logical_or)
LOGICAL_XOR = _Op(torch.logical_xor, tensors=True, compare=True, np_fn=np.logical_xor)


@dataclasses.dataclass
class Field:
    """Discrete field over a Domain, backed by a torch tensor or a NumPy
    array (one axis per domain dimension). Supports arithmetic,
    comparison, shifts via ``field(offset)``, and reductions via
    fbuiltins."""

    domain: Domain
    ndarray: Any
    # Validity mask for gathered neighbor values (skip_value handling);
    # None = all valid. Same shape as ndarray.
    mask: Any = None
    # The values come from a Python scalar (fbuiltins.broadcast): they
    # promote as a weak type, as a weakly typed JAX array does.
    weak: bool = False

    # Opt out of NumPy ufunc dispatch: ``np.float64(x) <= field`` must
    # defer to the reflected Field operator (mask field), not attempt
    # element-wise broadcasting over the Field object.
    __array_ufunc__ = None

    def __post_init__(self):
        if isinstance(self.ndarray, np.generic):  # NumPy's 0-d results
            self.ndarray = np.asarray(self.ndarray)
        expected = tuple(
            1 if not r.unit_range.is_finite else len(r.unit_range)
            for r in self.domain.ranges
        )
        if tuple(self.ndarray.shape) != expected:
            raise ValueError(
                f"Array shape {tuple(self.ndarray.shape)} does not match domain "
                f"{self.domain} shape {expected}"
            )

    # Annotation syntax: ``Field[Dims[I, J], float]`` yields a
    # :class:`gt4py_tpu_torch.next.type_system.FieldType` spec usable as a DSL
    # parameter/return annotation.
    def __class_getitem__(cls, item):
        from gt4py_tpu_torch.next.type_system import FieldType

        if not (isinstance(item, tuple) and len(item) == 2):
            raise TypeError(
                "Field[...] annotations take two arguments: Field[Dims[...], dtype]"
            )
        dims, dtype = item
        if isinstance(dims, Dimension):
            dims = (dims,)
        if not (
            isinstance(dims, tuple) and all(isinstance(d, Dimension) for d in dims)
        ):
            raise TypeError(f"Field[...] expects Dims[...] first, got {dims!r}")
        return FieldType(dims=tuple(dims), dtype=np.dtype(dtype))

    # -- interface ---------------------------------------------------------

    @property
    def dtype(self):
        if isinstance(self.ndarray, np.ndarray):
            return _np_dtype_of(self.ndarray)
        return numpy_dtype(self.ndarray.dtype)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.ndarray.shape)

    @property
    def dims(self) -> tuple[Dimension, ...]:
        return self.domain.dims

    @property
    def device(self) -> torch.device:
        return getattr(self.ndarray, "device", torch.device("cpu"))

    @property
    def ops(self):
        """The operation table of the array's namespace."""
        return NUMPY_OPS if isinstance(self.ndarray, np.ndarray) else TORCH_OPS

    def asnumpy(self) -> np.ndarray:
        return asnumpy(self.ndarray)

    def as_scalar(self):
        """The value of a zero-dimensional field, as a NumPy scalar of its
        dtype (a typed scalar, as the JAX package's 0-d array is)."""
        if self.domain.ndim != 0:
            raise ValueError("as_scalar requires a zero-dimensional field")
        value = asnumpy(self.ndarray)[()]
        return np.float32(value) if isinstance(self.ndarray, Bf16Array) else value

    # -- shifts ------------------------------------------------------------

    def __call__(
        self,
        offset: Union[OffsetIndex, FieldOffset, "Connectivity"],
        *more: Union[OffsetIndex, FieldOffset, "Connectivity"],
    ) -> "Field":
        """Shift/remap (reference NdArrayField.premap, nd_array_field.py:240).
        Multiple offsets fold left-to-right (reference __call__:369)."""
        if more:
            result = self(offset)
            for o in more:
                result = result(o)
            return result
        if isinstance(offset, OffsetIndex):
            provider = _OFFSET_PROVIDER.get()
            mapped = (provider or {}).get(offset.offset.value)
            if isinstance(mapped, Connectivity) or hasattr(mapped, "sharded_gather"):
                # Partial shift: gather only the index-th neighbor column.
                return self._remap_connectivity(mapped, column=offset.index)
            fo = offset.offset
            is_cartesian = isinstance(mapped, Dimension) or (
                mapped is None and fo.target == (fo.source,)
            )
            if not is_cartesian:
                raise RuntimeError(
                    f"Offset '{fo.value}' is unstructured; pass its Connectivity "
                    "via offset_provider"
                )
            return self._shift_cartesian(fo.source, offset.index)
        if isinstance(offset, FieldOffset):
            provider = _OFFSET_PROVIDER.get()
            mapped = (provider or {}).get(offset.value)
            if mapped is None:
                raise RuntimeError(
                    f"Offset '{offset.value}' not found in offset_provider"
                )
            if isinstance(mapped, Dimension):
                raise ValueError(
                    f"Cartesian offset '{offset.value}' requires an index: use "
                    f"{offset.value}[n]"
                )
            return self._remap_connectivity(mapped)
        if isinstance(offset, Connectivity):
            return self._remap_connectivity(offset)
        from gt4py_tpu_torch.next.common import CartesianConnectivity

        if isinstance(offset, CartesianConnectivity):
            if offset.codomain == offset.dim:
                return self._shift_cartesian(offset.dim, offset.offset)
            # Staggered premap (reference _domain_premap): the field lives
            # on ``codomain``; the result lives on ``dim`` with
            # result(i) = field(codomain(i + offset)).
            if offset.codomain not in self.domain:
                raise ValueError(
                    f"Cannot premap: field over {self.domain} has no "
                    f"{offset.codomain.value} dimension (needed by {offset!r})"
                )
            nr = self.domain[offset.codomain]
            new_range = NamedRange(offset.dim, nr.unit_range.shifted(-offset.offset))
            return self._like(
                self.domain.replace(offset.codomain, new_range), self.ndarray, self.mask
            )
        from gt4py_tpu_torch.next.experimental import AsOffset

        if isinstance(offset, AsOffset):
            return self._shift_dynamic(offset.offset.source, offset.index_field)
        raise TypeError(f"Cannot shift by {offset!r}")

    def _like(self, domain: Domain, array: Any, mask: Any = None) -> "Field":
        return Field(domain, array, mask, self.weak)

    def premap(self, offset) -> "Field":
        """Reference-name alias for shifting/remapping
        (NdArrayField.premap, nd_array_field.py:240)."""
        return self(offset)

    def restrict(self, domain_spec) -> "Field":
        """Restrict to a sub-domain (reference NdArrayField.restrict,
        nd_array_field.py:378): a view of this field's tensor."""
        from gt4py_tpu_torch.next.common import domain as make_domain

        target = make_domain(domain_spec)
        slices = []
        new_ranges = []
        for nr in self.domain.ranges:
            if nr.dim in target:
                tr = target[nr.dim].unit_range
                own = nr.unit_range
                if tr.start < own.start or tr.stop > own.stop:
                    raise ValueError(
                        f"restriction {tr} outside field range {own} for {nr.dim}"
                    )
                slices.append(slice(tr.start - own.start, tr.stop - own.start))
                new_ranges.append(NamedRange(nr.dim, tr))
            else:
                slices.append(slice(None))
                new_ranges.append(nr)
        arr = self.ndarray[tuple(slices)]
        mask = self.mask[tuple(slices)] if self.mask is not None else None
        return self._like(Domain(tuple(new_ranges)), arr, mask)

    def _restrict_relative(self, index: tuple) -> Any:
        """Relative (positional) indexing: tuples of slices / ints /
        Ellipsis over the domain dims in order (reference
        embedded/common.py:33 ``_relative_sub_domain``). Slices narrow the
        unit range in place; ints collapse the dimension. Negative values
        count from the range stop. Step slicing is rejected."""
        n = self.domain.ndim
        if sum(1 for e in index if e is Ellipsis) > 1:
            raise IndexError("an index can only have a single Ellipsis")
        if Ellipsis in index:
            at = index.index(Ellipsis)
            fill = n - (len(index) - 1)
            if fill < 0:
                raise IndexError(
                    f"too many indices for field with {n} dimensions: {index!r}"
                )
            index = index[:at] + (slice(None),) * fill + index[at + 1 :]
        if len(index) > n:
            raise IndexError(
                f"too many indices for field with {n} dimensions: {index!r}"
            )
        index = index + (slice(None),) * (n - len(index))
        ranges: list = []
        arr_index: list = []
        for nr, idx in zip(self.domain.ranges, index):
            rng = nr.unit_range
            if isinstance(idx, slice):
                if idx.step not in (None, 1):
                    raise IndexError("field slicing does not support a step")
                if not rng.is_finite:
                    if idx != slice(None):
                        raise IndexError(
                            f"cannot slice unbounded dimension {nr.dim}"
                        )
                    arr_index.append(slice(None))
                    ranges.append(nr)
                    continue
                lo, hi, _ = idx.indices(len(rng))
                hi = max(hi, lo)
                arr_index.append(slice(lo, hi))
                ranges.append(
                    NamedRange(nr.dim, UnitRange(rng.start + lo, rng.start + hi))
                )
            else:
                i = int(idx)
                if not rng.is_finite:
                    raise IndexError(f"cannot index unbounded dimension {nr.dim}")
                pos = i if i >= 0 else len(rng) + i
                if pos < 0 or pos >= len(rng):
                    raise IndexError(
                        f"index {i} out of range {rng} for {nr.dim}"
                    )
                arr_index.append(pos)
        result = self._like(
            Domain(tuple(ranges)),
            self.ndarray[tuple(arr_index)],
            self.mask[tuple(arr_index)] if self.mask is not None else None,
        )
        if result.domain.ndim == 0:
            return result.as_scalar()
        return result

    def _shift_dynamic(self, dim: Dimension, idx: "Field") -> "Field":
        """Per-point variable shift along ``dim`` (reference experimental
        ``as_offset``, ffront/experimental.py:17): out(p) = self(p + idx(p)
        along dim). The gather reads self's FULL extent along ``dim`` —
        offsets may reach halo points beyond the output domain. Out-of-range
        positions clamp to the field boundary."""
        dims = _promote_dims(self.dims, idx.dims)
        if dim not in dims or dim not in self.domain:
            raise ValueError(f"as_offset dimension {dim} not present")
        dom, _ = self._aligned(dims, idx)
        _, b = idx._aligned(dims, self)
        # source array: cropped to the output domain on every dim EXCEPT
        # the shifted one, kept full along it
        wide_probe = Field.__new__(Field)
        wide_probe.domain = dom.replace(
            dim, NamedRange(dim, self.domain[dim].unit_range)
        )
        _, a_wide = self._aligned(dims, wide_probe)
        axis = dom.dims.index(dim)
        n = a_wide.shape[axis]
        # output position i sits at (dom_start - self_start) + i in the
        # wide source array
        off0 = dom[dim].unit_range.start - self.domain[dim].unit_range.start
        shape = tuple(
            1 if not r.unit_range.is_finite else len(r.unit_range)
            for r in dom.ranges
        )
        view = [1] * len(shape)
        view[axis] = shape[axis]
        ops = self.ops
        base = ops.arange(shape[axis], a_wide).reshape(view) + off0
        pos = ops.clip(base + ops.as_int(b, a_wide), 0, n - 1)
        # take_along broadcasts index vs array on non-axis dims
        return Field(dom, ops.take_along(a_wide, pos, axis))

    def _shift_cartesian(self, dim: Dimension, index: int) -> "Field":
        """out(i) = self(i + index)  ⇔ domain range shifted by -index."""
        nr = self.domain[dim]
        new_range = NamedRange(dim, nr.unit_range.shifted(-index))
        return self._like(self.domain.replace(dim, new_range), self.ndarray, self.mask)

    def _remap_connectivity(
        self, conn: Connectivity, column: Optional[int] = None
    ) -> "Field":
        """One gather along the codomain axis (indices clamped into the
        field; ``skip_value`` entries masked)."""
        if self.domain.ndim == 0 or conn.codomain not in self.domain:
            raise ValueError(
                f"Field over {self.domain} cannot be remapped via {conn!r}"
            )
        axis = self.domain.index(conn.codomain)
        ops = self.ops
        table = ops.index(conn, column, self.ndarray)
        own_start = self.domain[conn.codomain].unit_range.start
        n = self.ndarray.shape[axis]
        shape = tuple(self.ndarray.shape)
        if hasattr(conn, "sharded_gather"):
            # One shard's explicit-ghost connectivity (parallel/
            # unstructured.DistributedUnstructured): its gather takes the
            # ring neighbours' halo slabs, then indexes the shard's table.
            if axis != 0:
                raise ValueError("sharded gathers require the codomain dimension first")
            gathered = conn.sharded_gather(self.ndarray, column)
        else:
            safe_idx = ops.clip(table - own_start, 0, n - 1)
            gathered = ops.gather(self.ndarray, axis, safe_idx.reshape(-1)).reshape(
                shape[:axis] + tuple(table.shape) + shape[axis + 1:]
            )
        # gathered axes: dims[:axis] + (source[, neighbor]) + dims[axis+1:]
        neighbor_ranges = (
            (NamedRange(conn.neighbor_dim, UnitRange(0, conn.table.shape[1])),)
            if column is None
            else ()
        )
        new_ranges = (
            self.domain.ranges[:axis]
            + (NamedRange(conn.source_dim, UnitRange(0, conn.table.shape[0])),)
            + neighbor_ranges
            + self.domain.ranges[axis + 1:]
        )
        mask = None
        if conn.skip_value is not None:
            valid = (table != conn.skip_value).reshape(
                (1,) * axis + tuple(table.shape) + (1,) * (self.ndarray.ndim - axis - 1)
            )
            mask = ops.expand(valid, gathered.shape)
        return Field(Domain(new_ranges), gathered, mask)

    def _reduce_index(self, dim: Dimension, index: int) -> "Field":
        axis = self.domain.index(dim)
        ops = self.ops
        taken = ops.take_index(self.ndarray, axis, index)
        mask = ops.take_index(self.mask, axis, index) if self.mask is not None else None
        return self._like(
            Domain(self.domain.ranges[:axis] + self.domain.ranges[axis + 1:]),
            taken,
            mask,
        )

    # -- restriction -------------------------------------------------------

    def __getitem__(self, item):
        """Absolute (domain-coordinate) indexing/restriction (reference
        NdArrayField.restrict :378): entries are NamedRanges,
        ``(dim, (start, stop))`` pairs (restrict), or ``(dim, index)`` pairs
        (collapse the dimension). Collapsing every dimension returns the
        scalar value."""
        # Relative (positional) indexing: plain slices / ints / Ellipsis
        # map onto domain dims in order (reference
        # common.py:415 is_relative_index_sequence).
        def _is_rel(e):
            return (
                e is Ellipsis
                or isinstance(e, slice)
                or (isinstance(e, (int, np.integer)) and not isinstance(e, bool))
            )

        if not isinstance(item, NamedRange):
            if _is_rel(item) and not isinstance(item, tuple):
                return self._restrict_relative((item,))
            if isinstance(item, tuple) and item and all(_is_rel(e) for e in item):
                return self._restrict_relative(item)

        # NamedRange is a tuple, so disambiguate the single-entry forms:
        # a NamedRange itself, or a (Dimension, index-or-range) pair.
        if isinstance(item, NamedRange):
            item = (item,)
        elif (
            isinstance(item, tuple)
            and len(item) == 2
            and isinstance(item[0], Dimension)
        ):
            item = (item,)
        elif not isinstance(item, tuple):
            item = (item,)
        ranges = list(self.domain.ranges)
        slices = [slice(None)] * self.domain.ndim
        collapses: list[tuple[Dimension, int]] = []
        for entry in item:
            if isinstance(entry, NamedRange):
                pass
            elif (
                isinstance(entry, tuple)
                and len(entry) == 2
                and isinstance(entry[0], Dimension)
            ):
                dim, spec = entry
                if isinstance(spec, int) and not isinstance(spec, bool):
                    own = self.domain[dim].unit_range
                    if spec not in own:
                        raise IndexError(
                            f"index {spec} out of range {own} for {dim}"
                        )
                    collapses.append((dim, spec - own.start))
                    continue
                entry = NamedRange(dim, UnitRange.from_value(spec))
            else:
                raise TypeError(f"Invalid restriction: {entry!r}")
            axis = self.domain.index(entry.dim)
            own = self.domain.ranges[axis].unit_range
            if (
                entry.unit_range.start < own.start
                or entry.unit_range.stop > own.stop
            ):
                raise IndexError(
                    f"restriction {entry.unit_range} outside field range "
                    f"{own} for {entry.dim}"
                )
            rel = slice(
                entry.unit_range.start - own.start,
                entry.unit_range.stop - own.start,
            )
            slices[axis] = rel
            ranges[axis] = entry
        result = self._like(
            Domain(tuple(ranges)),
            self.ndarray[tuple(slices)],
            self.mask[tuple(slices)] if self.mask is not None else None,
        )
        for dim, rel_idx in collapses:
            result = result._reduce_index(dim, rel_idx)
        if collapses and result.domain.ndim == 0:
            return result.as_scalar()
        return result

    # -- arithmetic --------------------------------------------------------

    def _binary(self, other, op: _Op) -> "Field":
        if not _is_operand(other):
            # e.g. the bridge's symbolic values: their reflected operator
            # decides (it refuses a Field, so the bridge falls back)
            return NotImplemented
        if isinstance(other, Field):
            self, other = _same_namespace(self, other)
            if other.domain.ranges == self.domain.ranges:
                dom, a, b = self.domain, self.ndarray, other.ndarray
                dims = self.dims
            else:
                dims = _promote_dims(self.dims, other.dims)
                dom, a = self._aligned(dims, other)
                _, b = other._aligned(dims, self)
            result, weak = op.apply(a, b, self.weak, other.weak)
            return Field(dom, result, _combine_masks(self, other, dims), weak)
        result, weak = op.apply(self.ndarray, self._operand(other), self.weak)
        return Field(self.domain, result, self.mask, weak)

    def _rbinary(self, other, op: _Op) -> "Field":
        if not _is_operand(other):
            return NotImplemented
        result, weak = op.apply(self._operand(other), self.ndarray, False, self.weak)
        return Field(self.domain, result, self.mask, weak)

    def _operand(self, other: Any) -> Any:
        """A non-Field operand in this field's namespace: NumPy arrays
        become tensors on this field's device, tensors NumPy arrays beside a
        NumPy field."""
        if isinstance(self.ndarray, np.ndarray):
            return as_numpy_array(other)
        if isinstance(other, np.ndarray):
            return torch.as_tensor(other, device=self.ndarray.device)
        return other

    def _aligned(self, dims: tuple[Dimension, ...], other: "Field"):
        """Slice to the intersected domain over ``dims`` and broadcast-insert
        missing axes; returns (target domain, tensor view)."""
        target_ranges = []
        for d in dims:
            if d in self.domain and d in other.domain:
                r = self.domain[d].unit_range.intersection(other.domain[d].unit_range)
            elif d in self.domain:
                r = self.domain[d].unit_range
            else:
                r = other.domain[d].unit_range
            target_ranges.append(NamedRange(d, r))
        dom = Domain(tuple(target_ranges))

        arr = self.ndarray
        # Slice own dims to target ranges (in own axis order); axes with
        # unbounded ranges are broadcast placeholders (size 1) — no slicing.
        slices = []
        for nr in self.domain.ranges:
            t = dom[nr.dim].unit_range
            own = nr.unit_range
            if not own.is_finite:
                slices.append(slice(None))
            else:
                slices.append(slice(t.start - own.start, t.stop - own.start))
        arr = arr[tuple(slices)]
        # Transpose own dims into target order and insert missing axes.
        own_dims = [d for d in dims if d in self.domain]
        perm = [self.domain.index(d) for d in own_dims]
        ops = self.ops
        if perm != sorted(perm):
            arr = ops.permute(arr, perm)

        shape = []
        for i, d in enumerate(dims):
            size = (
                len(dom[d].unit_range) if dom[d].unit_range.is_finite else 1
            )
            if d not in self.domain:
                arr = ops.unsqueeze(arr, i)
            shape.append(size)
        arr = ops.expand(arr, tuple(shape))
        return dom, arr

    def __add__(self, o):
        return self._binary(o, ADD)

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, SUB)

    def __rsub__(self, o):
        return self._rbinary(o, SUB)

    def __mul__(self, o):
        return self._binary(o, MUL)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, TRUEDIV)

    def __rtruediv__(self, o):
        return self._rbinary(o, TRUEDIV)

    def __pow__(self, o):
        return self._binary(o, POW)

    def __rpow__(self, o):
        return self._rbinary(o, POW)

    def __mod__(self, o):
        return self._binary(o, MOD)

    def __rmod__(self, o):
        return self._rbinary(o, MOD)

    def __floordiv__(self, o):
        return self._binary(o, FLOORDIV)

    def __rfloordiv__(self, o):
        return self._rbinary(o, FLOORDIV)

    def __neg__(self):
        return self._like(self.domain, -self.ndarray, self.mask)

    def __pos__(self):
        return self

    def __abs__(self):
        return self._like(self.domain, self.ops.abs(self.ndarray), self.mask)

    def __invert__(self):
        return Field(self.domain, self.ops.logical_not(self.ndarray), self.mask)

    def __and__(self, o):
        return self._binary(o, LOGICAL_AND)

    def __or__(self, o):
        return self._binary(o, LOGICAL_OR)

    def __xor__(self, o):
        return self._binary(o, LOGICAL_XOR)

    def __eq__(self, o):  # type: ignore[override]
        return self._binary(o, EQ)

    def __ne__(self, o):  # type: ignore[override]
        return self._binary(o, NE)

    def __lt__(self, o):
        return self._binary(o, LT)

    def __le__(self, o):
        return self._binary(o, LE)

    def __gt__(self, o):
        return self._binary(o, GT)

    def __ge__(self, o):
        return self._binary(o, GE)

    def __hash__(self):
        return id(self)

    def __bool__(self):
        # Without this, Python's chained comparison `a < b < c` silently
        # evaluates as just `b < c` (the intermediate Field is truthy by
        # default) — a wrong-RESULTS trap, not an error.
        raise TypeError(
            "The truth value of a Field is ambiguous. For element-wise "
            "conjunction write (a < b) & (b < c); for branching use where()."
        )

    def __repr__(self) -> str:
        return f"Field({self.domain}, dtype={self.dtype})"


def _combine_masks(a: Field, b: Field, dims):
    if a.mask is None and b.mask is None:
        return None
    parts = []
    for f in (a, b):
        if f.mask is not None:
            mf = Field(f.domain, f.mask)
            _, arr = mf._aligned(dims, b if f is a else a)
            parts.append(arr)
    out = parts[0]
    for p in parts[1:]:
        out = ops_of(out, p).logical_and(out, p)
    return out


def _same_namespace(a: Field, b: Field) -> tuple:
    """Two Fields over one namespace: beside a NumPy Field, a Field over a
    CPU tensor is viewed as NumPy (one on a card raises)."""
    a_np, b_np = isinstance(a.ndarray, np.ndarray), isinstance(b.ndarray, np.ndarray)
    if a_np == b_np:
        return a, b
    if a_np:
        return a, as_numpy_field(b)
    return as_numpy_field(a), b


def as_numpy_field(field: Field) -> Field:
    """``field`` over NumPy: a view of its CPU tensor (see
    :func:`as_numpy_array`)."""
    if isinstance(field.ndarray, np.ndarray):
        return field
    mask = None if field.mask is None else as_numpy_array(field.mask)
    return Field(field.domain, as_numpy_array(field.ndarray), mask, field.weak)
