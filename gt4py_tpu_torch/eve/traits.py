"""Symbol-table traits for IR nodes.

Copied from gt4py_tpu/eve/traits.py; imports renamed.

Role of the reference's ``gt4py.eve.traits``
(src/gt4py/eve/traits.py:22,87,137,149): nodes that own a
scope collect the symbols declared in their subtree; a validating variant
checks that every reference resolves.
"""

from __future__ import annotations

from typing import Any, Type

from gt4py_tpu_torch.eve.concepts import Node, SymbolName, SymbolRef
from gt4py_tpu_torch.eve.trees import walk_values
from gt4py_tpu_torch.eve.visitors import NodeVisitor


__all__ = [
    "SymbolTableTrait",
    "collect_symbols",
    "validate_symbol_refs",
    "VisitorWithSymbolTable",
]


def collect_symbols(root: Node, *, stop_at: tuple[Type[Node], ...] = ()) -> dict[str, Node]:
    """Map symbol name -> declaring node for all ``SymbolName`` fields in the
    subtree, not descending into nested scopes (reference
    SymbolTableTrait.collect_symbols, eve/traits.py:22)."""
    table: dict[str, Node] = {}

    def _walk(node: Any) -> None:
        if isinstance(node, Node):
            for _, value in node.iter_children_items():
                if isinstance(value, SymbolName):
                    table[str(value)] = node
                if isinstance(value, stop_at) and value is not node:
                    continue
                _walk(value)
        elif isinstance(node, (list, tuple)):
            for v in node:
                _walk(v)
        elif isinstance(node, dict):
            for v in node.values():
                _walk(v)

    for _, value in root.iter_children_items():
        _walk(value)
    return table


class SymbolTableTrait:
    """Mixin marking a node as a scope; provides ``symtable_``
    (reference: eve/traits.py:22)."""

    @property
    def symtable_(self) -> dict[str, Node]:
        return collect_symbols(self)  # type: ignore[arg-type]


def validate_symbol_refs(root: Node) -> None:
    """Check every ``SymbolRef`` in the tree resolves against the symbol
    tables of its enclosing scopes (reference SymbolRefsValidatorTrait,
    eve/traits.py:87). Raises ``ValueError`` on a dangling reference."""

    def _validate(node: Node, scopes: list[dict[str, Node]]) -> None:
        if isinstance(node, SymbolTableTrait):
            scopes = scopes + [node.symtable_]
        for value in walk_values(node):
            if isinstance(value, SymbolRef):
                if not any(str(value) in s for s in scopes):
                    raise ValueError(f"Undefined symbol reference: {value!r}")

    _validate(root, [])


class VisitorWithSymbolTable(NodeVisitor):
    """Visitor that threads the active symbol-table stack through ``visit``
    as the ``symtable`` kwarg (reference VisitorWithSymbolTableTrait,
    eve/traits.py:149)."""

    def visit(self, node: Any, **kwargs: Any) -> Any:
        symtable = kwargs.pop("symtable", {})
        if isinstance(node, SymbolTableTrait):
            symtable = {**symtable, **node.symtable_}
        return super().visit(node, symtable=symtable, **kwargs)
