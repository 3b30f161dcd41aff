"""Runtime type validation kit.

Copied from gt4py_tpu/eve/type_validation.py; imports renamed.

Counterpart of the reference's ``gt4py.eve.type_validation``
(src/gt4py/eve/type_validation.py: ``TypeValidator``
protocol + ``simple_type_validator`` factory): structural checks of
values against typing annotations, usable standalone or through
``eve.datamodels`` (whose validated dataclasses delegate here).

Supported annotation forms: plain classes, ``Any``, ``Optional``/
``Union``, ``list``/``set``/``frozenset``/``tuple``/``dict`` generics
(recursively), and forward references by name (skipped — best effort,
like the reference's non-strict mode).
"""

from __future__ import annotations

from typing import Any, Callable, Union, get_args, get_origin


__all__ = [
    "TypeValidationError",
    "assert_type",
    "simple_type_validator",
]


class TypeValidationError(TypeError):
    """A value failed structural validation against an annotation."""


def assert_type(value: Any, annotation: Any, name: str = "value") -> None:
    """Raise :class:`TypeValidationError` unless ``value`` structurally
    matches ``annotation`` (reference simple_type_validator semantics)."""
    if annotation is Any or isinstance(annotation, str):
        return
    origin = get_origin(annotation)
    if origin is None:
        if isinstance(annotation, type) and not isinstance(value, annotation):
            # bool is an int subclass; ints are acceptable floats.
            if annotation is float and isinstance(value, int):
                return
            raise TypeValidationError(
                f"'{name}' expects {annotation.__name__}, got "
                f"{type(value).__name__} ({value!r})"
            )
        return
    if origin is Union:
        errors = []
        for arm in get_args(annotation):
            if arm is type(None) and value is None:
                return
            try:
                assert_type(value, arm, name)
                return
            except TypeValidationError as e:
                errors.append(str(e))
        raise TypeValidationError(
            f"'{name}' matches no Union arm of {annotation}: {value!r}"
        )
    if origin in (list, set, frozenset):
        if not isinstance(value, origin):
            raise TypeValidationError(f"'{name}' expects {origin.__name__}")
        (arg,) = get_args(annotation) or (Any,)
        for v in value:
            assert_type(v, arg, name)
        return
    if origin is tuple:
        if not isinstance(value, tuple):
            raise TypeValidationError(f"'{name}' expects tuple")
        args = get_args(annotation)
        if len(args) == 2 and args[1] is Ellipsis:
            for v in value:
                assert_type(v, args[0], name)
        elif args:
            if len(args) != len(value):
                raise TypeValidationError(
                    f"'{name}' expects a {len(args)}-tuple, got {len(value)}"
                )
            for v, a in zip(value, args):
                assert_type(v, a, name)
        return
    if origin is dict:
        if not isinstance(value, dict):
            raise TypeValidationError(f"'{name}' expects dict")
        args = get_args(annotation)
        if args:
            for k, v in value.items():
                assert_type(k, args[0], name)
                assert_type(v, args[1], name)
        return
    if isinstance(origin, type) and not isinstance(value, origin):
        raise TypeValidationError(
            f"'{name}' expects {origin.__name__}, got {type(value).__name__}"
        )


def simple_type_validator(annotation: Any, name: str = "value") -> Callable[[Any], None]:
    """A reusable validator closure for one annotation (reference
    simple_type_validator factory)."""

    def validate(value: Any) -> None:
        assert_type(value, annotation, name)

    return validate
