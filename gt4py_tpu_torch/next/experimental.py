"""Experimental field-view builtins.

Counterpart of the reference's ``gt4py.next.ffront.experimental``
(src/gt4py/next/ffront/experimental.py:17,52): ``as_offset``
(per-point variable shifts) and ``concat_where`` (domain-boundary
conditionals; re-exported from fbuiltins where it is implemented).

Copied from gt4py_tpu/next/experimental.py; imports renamed.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from gt4py_tpu_torch.next.common import FieldOffset
from gt4py_tpu_torch.next.fbuiltins import concat_where  # noqa: F401


@dataclasses.dataclass(frozen=True)
class AsOffset:
    """A variable offset: shift amounts come from an index field."""

    offset: FieldOffset
    index_field: Any


def as_offset(offset: FieldOffset, index_field: Any) -> AsOffset:
    """Use inside an operator as ``field(as_offset(Koff, idx))``: reads
    ``field`` at ``k + idx(p)`` per point (reference experimental.py:17)."""
    return AsOffset(offset, index_field)
