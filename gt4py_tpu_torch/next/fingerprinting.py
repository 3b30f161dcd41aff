"""Stable content fingerprinting for definitions and arguments.

Role of the reference's ``gt4py.next.fingerprinting``
(src/gt4py/next/fingerprinting.py:69,116): deterministic
hashes of (function source, closure values, argument type signatures) used
as keys for the compiled-programs pool and persistent caches.

Copied from gt4py_tpu/next/fingerprinting.py; imports renamed.
"""

from __future__ import annotations

import hashlib
import inspect
import textwrap
from typing import Any, Callable

import numpy as np


def _pieces(value: Any) -> Any:
    """Deconstruct a value into hashable primitives (reference
    Deconstruction.from_pieces, fingerprinting.py:116)."""
    from gt4py_tpu_torch.next.common import Connectivity, Dimension, Domain, UnitRange

    if isinstance(value, (str, int, float, bool, bytes, type(None))):
        return value
    if isinstance(value, np.dtype):
        return ("dtype", value.str)
    if isinstance(value, Dimension):
        return ("dim", value.value, value.kind.value)
    if isinstance(value, UnitRange):
        return ("urange", value.start, value.stop)
    if isinstance(value, Domain):
        return ("domain", tuple(_pieces(nr.dim) + (_pieces(nr.unit_range),) for nr in value.ranges))
    if isinstance(value, Connectivity):
        # Identity of the table, not its contents (tables are large).
        return ("conn", value.source_dim.value, value.neighbor_dim.value, value.max_neighbors, id(value.table))
    if isinstance(value, (tuple, list)):
        return tuple(_pieces(v) for v in value)
    if isinstance(value, dict):
        return tuple(sorted((k, _pieces(v)) for k, v in value.items()))
    if isinstance(value, type):
        return ("type", value.__module__, value.__qualname__)
    if callable(value):
        return ("fn", fingerprint_function(value))
    return ("repr", repr(value))


def fingerprint(*values: Any, length: int = 16) -> str:
    """Stable hash of arbitrary (nested) values."""
    data = repr(tuple(_pieces(v) for v in values)).encode()
    return hashlib.sha256(data).hexdigest()[:length]


def fingerprint_function(fn: Callable, *, length: int = 16) -> str:
    """Hash of a function's source + module + qualname (reference
    stages fingerprints, ffront/stages.py)."""
    try:
        src = textwrap.dedent(inspect.getsource(fn))
    except (OSError, TypeError):
        src = repr(fn)
    data = "\x00".join(
        [getattr(fn, "__module__", "") or "", getattr(fn, "__qualname__", "") or "", src]
    ).encode()
    return hashlib.sha256(data).hexdigest()[:length]
