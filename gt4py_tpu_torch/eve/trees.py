"""Generic tree iteration over Node / list / tuple / dict structures.

Copied from gt4py_tpu/eve/trees.py; imports renamed.

Role of the reference's ``gt4py.eve.trees`` (src/gt4py/eve/
trees.py): uniform pre-/post-order walks over heterogeneous IR trees.
"""

from __future__ import annotations

from typing import Any, Iterator

from gt4py_tpu_torch.eve.concepts import Node


__all__ = [
    "iter_tree_children",
    "walk_values",
    "post_walk_values",
    "walk_type",
    "pre_walk_items",
]


def iter_tree_children(value: Any) -> Iterator[Any]:
    if isinstance(value, Node):
        yield from value.iter_children_values()
    elif isinstance(value, (list, tuple)):
        yield from value
    elif isinstance(value, dict):
        yield from value.values()


def walk_values(node: Any) -> Iterator[Any]:
    """Pre-order traversal of all values in the tree (reference: eve/trees.py)."""
    yield node
    for child in iter_tree_children(node):
        yield from walk_values(child)


def post_walk_values(node: Any) -> Iterator[Any]:
    """Post-order traversal (children before parents)."""
    for child in iter_tree_children(node):
        yield from post_walk_values(child)
    yield node


def walk_type(node: Any, node_type: type) -> Iterator[Any]:
    for value in walk_values(node):
        if isinstance(value, node_type):
            yield value


def pre_walk_items(node: Any, *, _key: Any = None) -> Iterator[tuple[Any, Any]]:
    yield _key, node
    if isinstance(node, Node):
        for key, child in node.iter_children_items():
            yield from pre_walk_items(child, _key=key)
    elif isinstance(node, (list, tuple)):
        for i, child in enumerate(node):
            yield from pre_walk_items(child, _key=i)
    elif isinstance(node, dict):
        for key, child in node.items():
            yield from pre_walk_items(child, _key=key)
