"""Type specifications for the field-view DSL.

Role of the reference's ``gt4py.next.type_system``
(src/gt4py/next/type_system/type_specifications.py:97-208,
type_translation.py, type_info.py): a small tree of type specs, translation
from Python annotations / runtime values, and promotion rules. Used by the
AOT compile pool to validate and fingerprint argument signatures.

Copied from gt4py_tpu/next/type_system.py; imports renamed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np

from gt4py_tpu_torch.next.common import Dimension, Domain


class TypeSpec:
    """Base class of all type specifications (reference
    type_specifications.py:52)."""

    __slots__ = ()


@dataclasses.dataclass(frozen=True)
class ScalarType(TypeSpec):
    """A NumPy scalar kind (reference :97)."""

    dtype: np.dtype

    def __str__(self) -> str:
        return str(self.dtype)


@dataclasses.dataclass(frozen=True)
class DimensionType(TypeSpec):
    dim: Dimension


@dataclasses.dataclass(frozen=True)
class FieldType(TypeSpec):
    """Field over dims with an element type (reference :120)."""

    dims: tuple[Dimension, ...]
    dtype: np.dtype

    def __str__(self) -> str:
        dims = ", ".join(d.value for d in self.dims)
        return f"Field[[{dims}], {self.dtype}]"


@dataclasses.dataclass(frozen=True)
class TupleType(TypeSpec):
    """Heterogeneous tuple (reference :135)."""

    types: tuple[TypeSpec, ...]

    def __str__(self) -> str:
        return f"tuple[{', '.join(map(str, self.types))}]"


@dataclasses.dataclass(frozen=True)
class FunctionType(TypeSpec):
    """Callable signature (reference :208)."""

    pos_only_args: tuple[TypeSpec, ...]
    pos_or_kw_args: dict[str, TypeSpec] = dataclasses.field(default_factory=dict)
    kw_only_args: dict[str, TypeSpec] = dataclasses.field(default_factory=dict)
    returns: Optional[TypeSpec] = None

    def __hash__(self) -> int:
        return hash(
            (
                self.pos_only_args,
                tuple(self.pos_or_kw_args.items()),
                tuple(self.kw_only_args.items()),
                self.returns,
            )
        )


def from_value(value: Any) -> TypeSpec:
    """TypeSpec of a runtime value (reference type_translation.py
    from_value)."""
    from gt4py_tpu_torch.next.embedded import Field

    if isinstance(value, Field):
        return FieldType(dims=value.dims, dtype=np.dtype(value.dtype))
    from gt4py_tpu_torch.next.named_collections import is_named_collection

    if is_named_collection(value):
        names = type(value).__named_collection_fields__
        return TupleType(types=tuple(from_value(getattr(value, n)) for n in names))
    if isinstance(value, tuple):
        return TupleType(types=tuple(from_value(v) for v in value))
    if isinstance(value, (bool, np.bool_)):
        return ScalarType(np.dtype(bool))
    if isinstance(value, (int, np.integer)):
        return ScalarType(np.dtype(np.int64))
    if isinstance(value, (float, np.floating)):
        return ScalarType(np.dtype(np.float64))
    if isinstance(value, np.ndarray) and value.ndim == 0:
        return ScalarType(value.dtype)
    if hasattr(value, "dtype") and hasattr(value, "ndim") and value.ndim == 0:
        return ScalarType(np.dtype(value.dtype))
    if hasattr(value, "ndim") and getattr(value, "ndim", 0) > 0:
        raise TypeError(
            f"Cannot deduce a TypeSpec for a raw {getattr(value, 'shape', '?')} "
            "array — wrap operator arguments as Fields (gtx.as_field([dims], data))"
        )
    raise TypeError(f"Cannot deduce a TypeSpec for {value!r}")


def from_annotation(ann: Any, globalns: Optional[dict] = None) -> Optional[TypeSpec]:
    """TypeSpec of a DSL annotation (reference type_translation.py
    ``from_type_hint``): ``Field[Dims[I, J], float]`` evaluates to a
    :class:`FieldType` via ``Field.__class_getitem__``; scalar kinds and
    ``tuple[...]`` compose. Returns None for annotations the DSL does not
    type (deduction then skips the parameter)."""
    import typing

    import inspect

    if ann is None or ann is inspect.Parameter.empty:
        return None
    if isinstance(ann, str):
        try:
            ann = eval(ann, globalns or {})  # noqa: S307 — annotation string
        except Exception:
            return None
    if isinstance(ann, TypeSpec):
        return ann
    if isinstance(ann, Dimension):
        return DimensionType(ann)
    origin = typing.get_origin(ann)
    if origin is tuple:
        parts = tuple(from_annotation(a, globalns) for a in typing.get_args(ann))
        if any(p is None for p in parts):
            return None
        return TupleType(types=parts)
    try:
        dt = np.dtype(ann)
    except TypeError:
        return None
    if dt.kind == "O":
        # arbitrary classes (NamedTuple carries, user types) collapse to
        # np.dtype(object) — that is not a scalar annotation
        return None
    return ScalarType(dt)


def promote(*types: ScalarType) -> ScalarType:
    """NumPy promotion over scalar kinds (reference type_info.promote)."""
    return ScalarType(np.result_type(*(t.dtype for t in types)))


def promote_dims(*dim_lists: Sequence[Dimension]) -> tuple[Dimension, ...]:
    """Order-preserving union of dimension lists (reference
    common.promote_dims, next/common.py:1367)."""
    from gt4py_tpu_torch.next.embedded import _promote_dims

    result: tuple[Dimension, ...] = ()
    for dims in dim_lists:
        result = _promote_dims(result, tuple(dims))
    return result


def is_concrete(spec: TypeSpec) -> bool:
    return isinstance(spec, (ScalarType, FieldType, DimensionType)) or (
        isinstance(spec, TupleType) and all(is_concrete(t) for t in spec.types)
    )
