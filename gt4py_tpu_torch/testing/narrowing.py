"""GTIR dtype narrowing: 64-bit → 32-bit rewrite.

Copied from gt4py_tpu/testing/narrowing.py; imports renamed. The JAX
package narrows because Mosaic has no 64-bit types; for the port it gives
the float32 runs of the float64 test corpus. ``narrow_stencil`` rewrites an
analyzed-able GTIR tree in place-free copy form: every float64 → float32,
int64 → int32, in declarations, literals, casts, and annotated expression
dtypes (reference analog: the dtype parametrization of StencilTestSuite,
src/gt4py/cartesian/testing/suites.py:196).
"""

from __future__ import annotations

import numpy as np

from gt4py_tpu_torch import eve
from gt4py_tpu_torch.cartesian import gtir

_NARROW = {
    np.dtype(np.float64): np.dtype(np.float32),
    np.dtype(np.int64): np.dtype(np.int32),
    np.dtype(np.uint64): np.dtype(np.uint32),
}


def _narrow_dtype(dtype):
    if dtype is None:
        return None
    return _NARROW.get(np.dtype(dtype), np.dtype(dtype))


def narrow_stencil(stencil: gtir.Stencil) -> gtir.Stencil:
    """Return a deep copy of ``stencil`` with every 64-bit dtype narrowed
    to its 32-bit counterpart."""
    # datamodel copy() is shallow for nested lists; rebuild via the pretty
    # round-trip for a guaranteed-independent tree.
    from gt4py_tpu_torch.cartesian.gtir_pretty import parse, pretty

    copy = parse(pretty(stencil))
    for decl in list(copy.params) + list(copy.temporaries):
        if getattr(decl, "dtype", None) is not None:
            decl.dtype = _narrow_dtype(decl.dtype)
    for vloop in copy.vertical_loops:
        for section in vloop.sections:
            for stmt in section.body:
                for node in eve.walk_values(stmt):
                    if hasattr(node, "dtype") and getattr(node, "dtype", None) is not None:
                        node.dtype = _narrow_dtype(node.dtype)
    return copy
