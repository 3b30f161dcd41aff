"""Validated dataclasses ("datamodels").

Copied from gt4py_tpu/eve/datamodels.py; imports renamed.

Counterpart of the reference's ``gt4py.eve.datamodels``
(src/gt4py/eve/datamodels/core.py:270,425,503,594,620):
dataclasses with optional runtime type checking of annotated fields plus
field- and root-validators. The default IR nodes (:func:`eve.datamodel`)
skip validation for speed; use :func:`datamodel(validate=True)` or this
module's decorator where construction-time checking is wanted (frontend
boundary objects, options records).
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Callable, Optional, Union, get_args, get_origin


__all__ = ["datamodel", "field", "validator", "root_validator", "ValidationError"]

field = dataclasses.field


class ValidationError(TypeError):
    """A field failed type or value validation."""


def _check_type(value: Any, annotation: Any, name: str) -> None:
    """Structural check (delegates to the standalone kit,
    eve/type_validation.py; ValidationError subclasses its error)."""
    from gt4py_tpu_torch.eve import type_validation

    try:
        type_validation.assert_type(value, annotation, name)
    except type_validation.TypeValidationError as e:
        raise ValidationError(str(e)) from None


def validator(field_name: str):
    """Declare a field validator method: ``def _v(self, value) -> None``
    (reference core.py:594)."""

    def mark(fn: Callable) -> Callable:
        fn.__datamodel_validator__ = field_name
        return fn

    return mark


def root_validator(fn: Callable) -> Callable:
    """Declare a whole-instance validator (reference core.py:620)."""
    fn.__datamodel_root_validator__ = True
    return fn


def datamodel(cls=None, /, *, frozen: bool = False, validate: bool = True):
    """Dataclass with runtime validation (reference core.py:270)."""

    def wrap(c):
        if not validate:
            return dataclasses.dataclass(frozen=frozen)(c)

        # __post_init__ must exist BEFORE @dataclass runs: the generated
        # __init__ only calls it if present at decoration time. The hint /
        # validator tables fill in afterwards (closures).
        hints: dict[str, Any] = {}
        field_validators: list[tuple[str, Callable]] = []
        root_validators: list[Callable] = []
        orig_post_init = getattr(c, "__post_init__", None)

        def __post_init__(self):
            for f in dataclasses.fields(self):
                ann = hints.get(f.name, Any)
                _check_type(getattr(self, f.name), ann, f.name)
            for target, fn in field_validators:
                fn(self, getattr(self, target))
            for fn in root_validators:
                fn(self)
            if orig_post_init is not None:
                orig_post_init(self)

        c.__post_init__ = __post_init__
        c = dataclasses.dataclass(frozen=frozen)(c)
        hints.update(typing.get_type_hints(c))
        for attr in vars(c).values():
            target = getattr(attr, "__datamodel_validator__", None)
            if target is not None:
                field_validators.append((target, attr))
            if getattr(attr, "__datamodel_root_validator__", False):
                root_validators.append(attr)
        return c

    return wrap(cls) if cls is not None else wrap
