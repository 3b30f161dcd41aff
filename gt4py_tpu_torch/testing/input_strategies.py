"""Input strategy declarations for stencil test suites.

Copied from gt4py_tpu/testing/input_strategies.py; imports renamed.
Counterpart of the reference's ``gt4py.cartesian.testing.input_strategies``
(src/gt4py/cartesian/testing/input_strategies.py:47-204): symbol
descriptors declaring how each stencil argument is generated — fields with
value ranges and per-axis boundary (halo) requirements, scalar parameters
with ranges or fixed sets.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class SymbolDescriptor:
    kind: str
    value_st_kwargs: dict
    boundary: tuple[tuple[int, int], ...] = ()
    axes: Optional[str] = None
    #: fixed dtype overriding the suite's parametrized dtype (index fields
    #: alongside float data, reference per-symbol dtype overrides)
    dtype: Optional[object] = None

    @property
    def is_field(self) -> bool:
        return self.kind == "field"


def field(
    in_range: tuple[float, float] = (-10.0, 10.0),
    *,
    boundary: Sequence[tuple[int, int]] = ((0, 0), (0, 0), (0, 0)),
    axes: str = "IJK",
    dtype=None,
) -> SymbolDescriptor:
    """Declare a field input generated by hypothesis within ``in_range``,
    extended by ``boundary`` halo points per axis (reference
    input_strategies.field_st). ``dtype`` pins this symbol's dtype
    independently of the suite's parametrized dtype (index fields)."""
    return SymbolDescriptor(
        kind="field",
        value_st_kwargs={"min_value": in_range[0], "max_value": in_range[1]},
        boundary=tuple(tuple(b) for b in boundary),
        axes=axes,
        dtype=dtype,
    )


def parameter(
    in_range: tuple[float, float] = (-10.0, 10.0),
    *,
    one_of: Optional[Sequence[Any]] = None,
) -> SymbolDescriptor:
    """Declare a scalar parameter (reference parameter_st / one_of)."""
    kwargs: dict = {"min_value": in_range[0], "max_value": in_range[1]}
    if one_of is not None:
        kwargs = {"one_of": tuple(one_of)}
    return SymbolDescriptor(kind="parameter", value_st_kwargs=kwargs)


def global_boundaries(symbols: dict[str, SymbolDescriptor]) -> tuple[tuple[int, int], ...]:
    """Per-axis max halo over all field symbols (drives domain origin)."""
    result = [(0, 0), (0, 0), (0, 0)]
    for desc in symbols.values():
        if desc.is_field:
            for ax, (lo, hi) in enumerate(desc.boundary):
                result[ax] = (max(result[ax][0], lo), max(result[ax][1], hi))
    return tuple(result)
