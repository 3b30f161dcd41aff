"""Structured DSL error reporting.

Role of the reference's ``gt4py.next.errors``
(src/gt4py/next/errors/exceptions.py:49,144 and
excepthook.py:40): exceptions carrying a :class:`SourceLocation`, a
did-you-mean suggestion helper for undefined symbols, and compact
formatting that points at the offending DSL source line.

Copied from gt4py_tpu/next/errors.py; imports renamed.
"""

from __future__ import annotations

import difflib
import linecache
import sys
import textwrap
from typing import Iterable, Optional

from gt4py_tpu_torch.eve import SourceLocation


class DSLError(Exception):
    """Base class for user-facing DSL errors (reference exceptions.py:49)."""

    def __init__(self, location: Optional[SourceLocation], message: str):
        self.location = location
        self.message = message
        super().__init__(message)

    def with_location(self, location: Optional[SourceLocation]) -> "DSLError":
        self.location = location
        return self

    def __str__(self) -> str:
        return format_error(self)


class DSLSyntaxError(DSLError):
    """Invalid construct in a DSL definition."""


class DSLTypeError(DSLError):
    """Type mismatch inside a DSL definition."""


class UndefinedSymbolError(DSLError):
    """Reference to an unknown symbol, with did-you-mean suggestions
    (reference exceptions.py:144, fuzzy matching at errors/exceptions.py:39)."""

    def __init__(
        self,
        location: Optional[SourceLocation],
        name: str,
        candidates: Iterable[str] = (),
    ):
        suggestion = suggest(name, candidates)
        msg = f"Undefined symbol: '{name}'."
        if suggestion:
            msg += f" Did you mean '{suggestion}'?"
        super().__init__(location, msg)
        self.name = name


class MissingParameterAnnotationError(DSLTypeError):
    def __init__(self, location: Optional[SourceLocation], name: str):
        super().__init__(location, f"Parameter '{name}' is missing a type annotation.")


class InvalidParameterAnnotationError(DSLTypeError):
    def __init__(self, location: Optional[SourceLocation], name: str, annotation: object):
        super().__init__(
            location, f"Parameter '{name}' has an invalid annotation: {annotation!r}."
        )


def suggest(name: str, candidates: Iterable[str]) -> Optional[str]:
    """Closest candidate by fuzzy match, or None."""
    matches = difflib.get_close_matches(name, list(candidates), n=1, cutoff=0.6)
    return matches[0] if matches else None


def format_error(err: DSLError) -> str:
    """Render message + source excerpt with a caret column marker."""
    parts = [err.message]
    loc = err.location
    if loc is not None:
        parts.append(f"  File \"{loc.filename}\", line {loc.line}")
        line = linecache.getline(loc.filename, loc.line).rstrip("\n")
        if line:
            stripped = line.lstrip()
            indent = len(line) - len(stripped)
            parts.append(f"    {stripped}")
            caret_col = max(loc.column - indent, 0)
            width = 1
            if loc.end_column is not None and loc.end_line == loc.line:
                width = max(loc.end_column - loc.column, 1)
            parts.append("    " + " " * caret_col + "^" * width)
    return "\n".join(parts)


_original_excepthook = None


def install_excepthook() -> None:
    """Print DSLErrors compactly (no traceback spam) unless
    GT4PY_VERBOSE_EXCEPTIONS (reference excepthook.py:40)."""
    global _original_excepthook
    from gt4py_tpu_torch import config

    if _original_excepthook is not None:
        return
    _original_excepthook = sys.excepthook

    def hook(exc_type, exc, tb):
        if issubclass(exc_type, DSLError) and not config.VERBOSE_EXCEPTIONS:
            print(f"{exc_type.__name__}: {exc}", file=sys.stderr)
        else:
            _original_excepthook(exc_type, exc, tb)

    sys.excepthook = hook


def uninstall_excepthook() -> None:
    global _original_excepthook
    if _original_excepthook is not None:
        sys.excepthook = _original_excepthook
        _original_excepthook = None
