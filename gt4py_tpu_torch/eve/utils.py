"""General-purpose utilities for the IR layers.

Copied from gt4py_tpu/eve/utils.py; imports renamed.

Role of the reference's ``gt4py.eve.utils``
(src/gt4py/eve/utils.py:745,808,910,960): stable content
hashing, case-style conversion for generated names, attribute namespaces,
and unique-id generation. The content hash dispatches to the native FNV-1a
implementation (csrc/fastpath.c) when built.
"""

from __future__ import annotations

import hashlib
import pickle
import re
import threading
from typing import Any, Iterable


__all__ = [
    "content_hash",
    "CaseStyleConverter",
    "Namespace",
    "FrozenNamespace",
    "UIDGenerator",
    "noninstantiable",
]


def _canonical(value: Any) -> Any:
    """Insertion-order-insensitive view of nested dicts/sets: equal values
    must hash equal (dict equality ignores order)."""
    if isinstance(value, dict):
        return (
            "__dict__",
            tuple(
                sorted(
                    ((repr(k), _canonical(v)) for k, v in value.items()),
                    key=lambda kv: kv[0],
                )
            ),
        )
    if isinstance(value, (set, frozenset)):
        return ("__set__", tuple(sorted(repr(_canonical(v)) for v in value)))
    if isinstance(value, (list, tuple)):
        marker = "__list__" if isinstance(value, list) else "__tuple__"
        return (marker, tuple(_canonical(v) for v in value))
    return value


def content_hash(*args: Any, length: int = 16) -> str:
    """Stable hash of (nested) values by pickled content
    (reference: eve/utils.py:745). Dict/set entries hash by CONTENT, not
    insertion order — two equal dicts always fingerprint equal."""
    data = pickle.dumps(_canonical(args), protocol=4)
    return hashlib.sha256(data).hexdigest()[:length]


class CaseStyleConverter:
    """Convert identifiers between naming conventions
    (reference: eve/utils.py:808)."""

    _SPLIT_CAMEL = re.compile(r"(?<=[a-z0-9])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])")

    @classmethod
    def split(cls, name: str) -> list[str]:
        if "_" in name:
            return [w for w in name.split("_") if w]
        if "-" in name:
            return [w for w in name.split("-") if w]
        return [w for w in cls._SPLIT_CAMEL.split(name) if w]

    @classmethod
    def convert(cls, name: str, target: str) -> str:
        words = [w.lower() for w in cls.split(name)]
        if target == "snake":
            return "_".join(words)
        if target == "kebab":
            return "-".join(words)
        if target == "camel":
            return words[0] + "".join(w.capitalize() for w in words[1:]) if words else ""
        if target == "pascal":
            return "".join(w.capitalize() for w in words)
        if target == "const":
            return "_".join(w.upper() for w in words)
        raise ValueError(f"Unknown case style: {target!r}")


class Namespace(dict):
    """Attribute-accessible dict (reference: eve/utils.py:910)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None


class FrozenNamespace:
    """Immutable attribute namespace (reference: eve/utils.py:960)."""

    def __init__(self, **items: Any):
        object.__setattr__(self, "_items", dict(items))

    def __getattr__(self, name: str) -> Any:
        items = object.__getattribute__(self, "_items")
        try:
            return items[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        raise AttributeError(f"FrozenNamespace is immutable (cannot set {name!r})")

    def __iter__(self) -> Iterable[str]:
        return iter(object.__getattribute__(self, "_items"))

    def keys(self):
        return object.__getattribute__(self, "_items").keys()

    def items(self):
        return object.__getattribute__(self, "_items").items()


class UIDGenerator:
    """Thread-safe unique-id generator for compiler-introduced names
    (reference: eve/utils.py uid generators)."""

    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self._counter = 0
        self._lock = threading.Lock()

    def sequential_id(self, *, prefix: str | None = None) -> str:
        with self._lock:
            self._counter += 1
            n = self._counter
        p = prefix if prefix is not None else self.prefix
        return f"{p}_{n}" if p else str(n)

    def reset_sequence(self, start: int = 0) -> None:
        with self._lock:
            self._counter = start


def noninstantiable(cls: type) -> type:
    """Class decorator preventing direct instantiation (reference:
    eve/utils.py noninstantiable)."""

    def _new(c, *args, **kwargs):
        if c is cls:
            raise TypeError(f"{cls.__name__} is non-instantiable")
        return object.__new__(c)

    cls.__new__ = _new  # type: ignore[method-assign]
    return cls
