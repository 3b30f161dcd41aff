"""Template-driven source generation.

Copied from gt4py_tpu/eve/codegen.py; imports renamed.

Counterpart of the reference's ``gt4py.eve.codegen``
(src/gt4py/eve/codegen.py:563,428,220,171): a
``TemplatedGenerator`` visitor whose class attributes are templates keyed
by node type, an indentation-aware ``TextBlock`` builder, and source
formatting. In this framework the backends trace IR into JAX programs, so
codegen is used for auxiliary text artifacts (reports, debug dumps,
generated test/oracle sources) rather than C++.
"""

from __future__ import annotations

import string
import textwrap
from typing import Any, Optional

from gt4py_tpu_torch.eve.concepts import Node
from gt4py_tpu_torch.eve.visitors import NodeVisitor


__all__ = [
    "FormatTemplate",
    "StringTemplate",
    "TemplatedGenerator",
    "TextBlock",
    "Name",
    "format_source",
]


class FormatTemplate:
    """``str.format``-based template (reference codegen.py:428). Visited
    children are available by field name; ``{_this_}`` is the node."""

    def __init__(self, fmt: str):
        self.fmt = fmt

    def render(self, node: Node, children: dict[str, Any]) -> str:
        return self.fmt.format(_this_=node, **children)


class StringTemplate:
    """``string.Template`` (`$name`) variant (reference codegen.py:451)."""

    def __init__(self, template: str):
        self.template = string.Template(template)

    def render(self, node: Node, children: dict[str, Any]) -> str:
        return self.template.substitute(**{k: str(v) for k, v in children.items()})


class Name:
    """Case-style-converting name placeholder (reference codegen.py:188)."""

    def __init__(self, style: str = "snake"):
        self.style = style

    def render(self, value: str) -> str:
        from gt4py_tpu_torch.eve.utils import CaseStyleConverter

        return CaseStyleConverter.convert(value, self.style)


class TextBlock:
    """Indentation-aware line accumulator (reference codegen.py:220)."""

    def __init__(self, *, indent_level: int = 0, indent_size: int = 4):
        self.indent_level = indent_level
        self.indent_size = indent_size
        self.lines: list[str] = []

    def append(self, line: str) -> "TextBlock":
        prefix = " " * (self.indent_level * self.indent_size)
        self.lines.append(prefix + line)
        return self

    def extend(self, lines) -> "TextBlock":
        for line in lines:
            self.append(line)
        return self

    def empty_line(self, count: int = 1) -> "TextBlock":
        self.lines.extend([""] * count)
        return self

    def indent(self, steps: int = 1) -> "TextBlock":
        self.indent_level += steps
        return self

    def dedent(self, steps: int = 1) -> "TextBlock":
        self.indent_level = max(0, self.indent_level - steps)
        return self

    def indented(self):
        block = self

        class _Ctx:
            def __enter__(self):
                block.indent()
                return block

            def __exit__(self, *exc):
                block.dedent()
                return False

        return _Ctx()

    @property
    def text(self) -> str:
        return "\n".join(self.lines)

    def __str__(self) -> str:
        return self.text


class TemplatedGenerator(NodeVisitor):
    """Visitor whose class attributes are templates keyed by node class
    name (reference codegen.py:563). ``apply()`` renders a tree to text:

    - a class attribute that is a template renders the node with its
      visited children as placeholders,
    - ``visit_<Class>`` methods override templates as usual,
    - untemplated nodes raise unless a ``generic_dump`` fallback exists.
    """

    @classmethod
    def apply(cls, node: Any, **kwargs: Any) -> str:
        return cls().visit(node, **kwargs)

    def visit(self, node: Any, **kwargs: Any) -> Any:
        method = None
        for klass in type(node).__mro__:
            method = getattr(self, f"visit_{klass.__name__}", None)
            if method is not None:
                return method(node, **kwargs)
        if isinstance(node, Node):
            template = None
            for klass in type(node).__mro__:
                template = getattr(type(self), klass.__name__, None)
                if template is not None and isinstance(
                    template, (FormatTemplate, StringTemplate, str)
                ):
                    break
                template = None
            children = {
                name: self.visit(value, **kwargs)
                for name, value in node.iter_children_items()
            }
            if template is None:
                return self.generic_dump(node, children)
            if isinstance(template, str):
                template = FormatTemplate(template)
            return template.render(node, children)
        if isinstance(node, (list, tuple)):
            return type(node)(self.visit(v, **kwargs) for v in node)
        if isinstance(node, dict):
            return {k: self.visit(v, **kwargs) for k, v in node.items()}
        return node

    # Collections must RENDER (visited element list), not traverse — the
    # base NodeVisitor's visit_list/visit_tuple return None by design and
    # would otherwise shadow the collection branch of visit() above.
    def visit_list(self, node: list, **kwargs: Any) -> Any:
        return [self.visit(v, **kwargs) for v in node]

    def visit_tuple(self, node: tuple, **kwargs: Any) -> Any:
        return tuple(self.visit(v, **kwargs) for v in node)

    def generic_dump(self, node: Node, children: dict[str, Any]) -> str:
        raise NotImplementedError(
            f"No template for node type {type(node).__name__} in "
            f"{type(self).__name__}"
        )


def format_source(language: str, source: str, *, line_length: int = 88) -> str:
    """Format generated source (reference codegen.py:171). Python goes
    through black when importable; other languages get whitespace
    normalization only (no clang-format dependency on TPU hosts)."""
    if language == "python":
        try:
            import black

            return black.format_str(
                source, mode=black.Mode(line_length=line_length)
            )
        except Exception:
            pass
    return textwrap.dedent(source).strip() + "\n"
