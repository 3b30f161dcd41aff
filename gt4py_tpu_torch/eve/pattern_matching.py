"""Structural matching of IR fragments.

Copied from gt4py_tpu/eve/pattern_matching.py; imports renamed.

Role of the reference's ``gt4py.eve.pattern_matching``
(src/gt4py/eve/pattern_matching.py:18): compare a tree
against a pattern object that fixes only some attributes, reporting the
mismatch paths. Used in pass unit tests.
"""

from __future__ import annotations

from typing import Any, Iterator


__all__ = ["ObjectPattern", "get_differences"]


class ObjectPattern:
    """Pattern matching any instance of ``cls`` whose attributes match the
    given (sub)patterns; unspecified attributes are ignored."""

    def __init__(self, cls: type, **fields: Any):
        self.cls = cls
        self.fields = fields

    def match(self, other: Any, *, raise_exception: bool = False) -> bool:
        diffs = list(get_differences(self, other))
        if diffs and raise_exception:
            msgs = "\n".join(f"  {path}: {msg}" for path, msg in diffs)
            raise ValueError(f"Pattern does not match:\n{msgs}")
        return not diffs

    def __repr__(self) -> str:
        attrs = ", ".join(f"{k}={v!r}" for k, v in self.fields.items())
        return f"{self.cls.__name__}Pattern({attrs})"


def get_differences(a: Any, b: Any, path: str = "") -> Iterator[tuple[str, str]]:
    """Yield (path, message) for each structural difference between pattern
    ``a`` and value ``b`` (reference: pattern_matching.py:30)."""
    if isinstance(a, ObjectPattern):
        if not isinstance(b, a.cls):
            yield path, f"expected instance of {a.cls.__name__}, got {type(b).__name__}"
            return
        for name, expected in a.fields.items():
            if not hasattr(b, name):
                yield f"{path}.{name}", "missing attribute"
                continue
            yield from get_differences(expected, getattr(b, name), f"{path}.{name}")
    elif isinstance(a, (list, tuple)) and not isinstance(a, str):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            yield path, f"expected sequence of length {len(a)}, got {b!r}"
            return
        for i, (ai, bi) in enumerate(zip(a, b)):
            yield from get_differences(ai, bi, f"{path}[{i}]")
    elif isinstance(a, dict):
        if not isinstance(b, dict) or set(a) - set(b):
            yield path, f"expected mapping with keys {sorted(a)}, got {b!r}"
            return
        for k in a:
            yield from get_differences(a[k], b[k], f"{path}[{k!r}]")
    else:
        if a != b:
            yield path, f"expected {a!r}, got {b!r}"
