"""Visitor and translator base classes.

Copied from gt4py_tpu/eve/visitors.py; imports renamed.

Role of the reference's ``gt4py.eve.visitors``
(src/gt4py/eve/visitors.py:23,102,143,150): per-class
dispatch with MRO fallback, and a translator that rebuilds trees while
preserving node annexes.
"""

from __future__ import annotations

from typing import Any

from gt4py_tpu_torch.eve.concepts import Node
from gt4py_tpu_torch.eve.trees import iter_tree_children


__all__ = ["NodeVisitor", "NodeTranslator"]


class NodeVisitor:
    """Visitor with per-class dispatch and MRO fallback.

    ``visit(node)`` dispatches to ``visit_<ClassName>`` for the node's class
    or the closest base class defining such a method; otherwise
    :meth:`generic_visit` recurses into children. Mirrors the dispatch
    contract of the reference (eve/visitors.py:102,143).
    """

    def visit(self, node: Any, **kwargs: Any) -> Any:
        method = None
        for cls in type(node).__mro__:
            method = getattr(self, f"visit_{cls.__name__}", None)
            if method is not None:
                break
        if method is None:
            method = self.generic_visit
        return method(node, **kwargs)

    def generic_visit(self, node: Any, **kwargs: Any) -> Any:
        for child in iter_tree_children(node):
            if isinstance(child, (Node, list, tuple, dict)):
                self.visit(child, **kwargs)
        return None

    def visit_list(self, node: list, **kwargs: Any) -> Any:
        for item in node:
            self.visit(item, **kwargs)

    def visit_tuple(self, node: tuple, **kwargs: Any) -> Any:
        for item in node:
            self.visit(item, **kwargs)


class NodeTranslator(NodeVisitor):
    """Visitor that rebuilds the tree; unhandled nodes are reconstructed
    with visited children, carrying over the annex (reference:
    eve/visitors.py:150)."""

    PRESERVED_ANNEX_ATTRS: tuple[str, ...] = ()

    def generic_visit(self, node: Any, **kwargs: Any) -> Any:
        if isinstance(node, Node):
            new_fields = {
                name: self.visit(value, **kwargs) if _is_tree(value) else value
                for name, value in node.iter_children_items()
            }
            new = type(node)(**new_fields)
            if "__node_annex__" in node.__dict__:
                old_annex = node.__dict__["__node_annex__"]
                for attr in self.PRESERVED_ANNEX_ATTRS:
                    if hasattr(old_annex, attr):
                        setattr(new.annex, attr, getattr(old_annex, attr))
            return new
        if isinstance(node, list):
            return [self.visit(v, **kwargs) if _is_tree(v) else v for v in node]
        if isinstance(node, tuple):
            return tuple(self.visit(v, **kwargs) if _is_tree(v) else v for v in node)
        if isinstance(node, dict):
            return {k: self.visit(v, **kwargs) if _is_tree(v) else v for k, v in node.items()}
        return node

    def visit_list(self, node: list, **kwargs: Any) -> Any:
        return self.generic_visit(node, **kwargs)

    def visit_tuple(self, node: tuple, **kwargs: Any) -> Any:
        return self.generic_visit(node, **kwargs)


def _is_tree(value: Any) -> bool:
    return isinstance(value, (Node, list, tuple, dict))
