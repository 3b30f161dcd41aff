"""IR-node base classes and source locations.

Copied from gt4py_tpu/eve/concepts.py; imports renamed.

TPU-native re-design of the reference's ``gt4py.eve.concepts``
(src/gt4py/eve/concepts.py:39-230). The reference builds
nodes on attrs-based "datamodels" with runtime type validation; here codegen
targets JAX/Pallas callables traced from the IR, so nodes are plain
dataclasses with structural equality and an out-of-band ``annex`` for
analysis results that must survive tree rewrites (reference AnnexManager,
concepts.py:226).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields
from typing import Any, Iterator, Optional


__all__ = [
    "Node",
    "SourceLocation",
    "SymbolName",
    "SymbolRef",
    "datamodel",
    "field",
]


@dataclass(frozen=True)
class SourceLocation:
    """Source position of a DSL construct (reference: eve/concepts.py:114)."""

    line: int
    column: int
    filename: str = "<unknown>"
    end_line: Optional[int] = None
    end_column: Optional[int] = None

    def __str__(self) -> str:
        return f"{self.filename}:{self.line}:{self.column}"


class SymbolName(str):
    """A name that introduces a symbol (reference: eve/concepts.py:45).

    Constrained to valid Python identifiers; used by symbol-table traits to
    collect declarations.
    """

    def __new__(cls, value: str) -> "SymbolName":
        if not value.isidentifier():
            raise ValueError(f"Invalid symbol name: {value!r}")
        return super().__new__(cls, value)


class SymbolRef(str):
    """A reference to a symbol declared elsewhere (reference: eve/concepts.py:52)."""

    __slots__ = ()


class Node:
    """Base class for IR nodes.

    Subclasses are plain (mutable) dataclasses created with the
    :func:`datamodel` decorator. Equality is structural over children;
    hash is identity (nodes are used as dict keys in analyses). The
    ``annex`` namespace carries analysis results out-of-band; translators
    copy it to rebuilt nodes (reference AnnexManager, eve/concepts.py:226).
    """

    __slots__ = ()

    def iter_children_items(self) -> Iterator[tuple[str, Any]]:
        for f in fields(self):  # type: ignore[arg-type]
            yield f.name, getattr(self, f.name)

    def iter_children_values(self) -> Iterator[Any]:
        for _, value in self.iter_children_items():
            yield value

    @property
    def annex(self) -> "_Annex":
        try:
            return self.__dict__["__node_annex__"]
        except KeyError:
            annex = _Annex()
            self.__dict__["__node_annex__"] = annex
            return annex

    def copy(self, **overrides: Any) -> "Node":
        new = dataclasses.replace(self, **overrides)  # type: ignore[type-var]
        if "__node_annex__" in self.__dict__:
            new.__dict__["__node_annex__"] = self.__dict__["__node_annex__"]
        return new

    def __eq__(self, other: Any) -> bool:
        if self is other:
            return True
        if type(self) is not type(other):
            return NotImplemented
        return all(
            getattr(self, f.name) == getattr(other, f.name)
            for f in fields(self)  # type: ignore[arg-type]
        )

    def __hash__(self) -> int:
        return id(self)

    def __repr__(self) -> str:
        parts = ", ".join(f"{k}={v!r}" for k, v in self.iter_children_items())
        return f"{type(self).__name__}({parts})"


class _Annex:
    """Attribute namespace attached lazily to a node (reference annex)."""

    def __repr__(self) -> str:
        return f"Annex({self.__dict__!r})"


def datamodel(cls=None, /, **kwargs):
    """Decorator turning a class into an IR-node dataclass.

    Equivalent role to the reference's ``@datamodel``
    (eve/datamodels/core.py:270) without runtime type validation —
    the frontend validates shapes/types before node construction.
    """

    def wrap(c):
        c = dataclasses.dataclass(eq=False, repr=False, **kwargs)(c)
        return c

    if cls is None:
        return wrap
    return wrap(cls)
