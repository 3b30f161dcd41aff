"""Named collections of fields.

Counterpart of gt4py_tpu/next/named_collections.py (role of the
reference's ``gt4py.next.named_collections``,
src/gt4py/next/named_collections.py:32,127,256): declare a dataclass-like
bundle of fields that DSL code can pass around as one object; provides
constructor/extractor helpers. The collection is registered as a torch
pytree node, so the scan operator's tree maps see through it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, TypeVar

import torch.utils._pytree as pytree

_T = TypeVar("_T")


def named_collection(cls: type[_T]) -> type[_T]:
    """Decorator: dataclass + pytree registration.

    Example::

        @named_collection
        class State:
            rho: Field
            vel: Field
    """
    cls = dataclasses.dataclass(cls)
    field_names = tuple(f.name for f in dataclasses.fields(cls))

    def flatten(obj):
        return [getattr(obj, n) for n in field_names], None

    def unflatten(children, _):
        return cls(*children)

    pytree.register_pytree_node(cls, flatten, unflatten)
    cls.__named_collection_fields__ = field_names  # type: ignore[attr-defined]
    return cls


def is_named_collection(obj: Any) -> bool:
    return hasattr(type(obj), "__named_collection_fields__")


def extract(obj: Any, name: str) -> Any:
    """Extractor (reference named_collections extractor codegen)."""
    if not is_named_collection(obj):
        raise TypeError(f"{type(obj).__name__} is not a named collection")
    return getattr(obj, name)


def constructor(cls: type[_T]) -> Callable[..., _T]:
    """Constructor helper bound to the collection class."""
    if not hasattr(cls, "__named_collection_fields__"):
        raise TypeError(f"{cls.__name__} is not a named collection")
    return cls
