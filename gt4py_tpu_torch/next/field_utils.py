"""Field utilities.

Counterpart of gt4py_tpu/next/field_utils.py (role of the reference's
``gt4py.next.field_utils``, src/gt4py/next/field_utils.py:26):
conversion to NumPy over (tuples of) fields, device verification, and
:func:`from_numpy` / :func:`connectivity_from_numpy`, which carry fields
and neighbour tables given as NumPy arrays with their dimension names and
domain starts (as the JAX package's are read out) into the port's.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from gt4py_tpu_torch.core.ndarray_utils import asnumpy as _asnumpy
from gt4py_tpu_torch.next.common import (
    Connectivity,
    Dimension,
    DimensionKind,
    Domain,
    NamedRange,
    UnitRange,
)
from gt4py_tpu_torch.next.embedded import Field


def asnumpy(value: Any) -> Any:
    """Recursively convert (tuples of) Fields/arrays to np.ndarray."""
    if isinstance(value, tuple):
        return tuple(asnumpy(v) for v in value)
    if isinstance(value, Field):
        return value.asnumpy()
    return _asnumpy(value)


def verify_device(value: Any, platform: str) -> bool:
    """True if all backing tensors live on the given device type
    ('cpu' | 'cuda')."""
    if isinstance(value, tuple):
        return all(verify_device(v, platform) for v in value)
    arr = value.ndarray if isinstance(value, Field) else value
    if not isinstance(arr, torch.Tensor):
        return platform == "cpu"
    return arr.device.type == platform


def field_from_typespec(spec: Any, domain, *, device: Any = None) -> Field:
    """Allocate a zero-filled Field matching a FieldType spec (reference
    field_utils.field_from_typespec), on the card unless ``device`` says
    otherwise."""
    from gt4py_tpu_torch.next.constructors import zeros
    from gt4py_tpu_torch.next.type_system import FieldType

    if not isinstance(spec, FieldType):
        raise TypeError(f"expected FieldType, got {spec!r}")
    dom = Domain(tuple(domain[d] for d in spec.dims))
    return zeros(dom, spec.dtype, device=device)


DimSpec = Union[Dimension, tuple]


def as_dimension(spec: DimSpec) -> Dimension:
    """A port Dimension from itself or from ``(name, kind)``, the kind as
    :class:`DimensionKind`'s value (``"horizontal"``, ``"vertical"``,
    ``"local"``)."""
    if isinstance(spec, Dimension):
        return spec
    name, kind = spec
    return Dimension(name, DimensionKind(kind))


def from_numpy(
    array: Any,
    dims: Sequence[DimSpec],
    *,
    starts: Optional[Sequence[int]] = None,
    device: Any = None,
) -> Field:
    """A port Field holding ``array`` (a NumPy array, or a tensor) over
    ``dims``, each range starting at ``starts`` (default 0), on ``device``
    (default: the card)."""
    from gt4py_tpu_torch.next.constructors import as_field

    dims = tuple(as_dimension(d) for d in dims)
    starts = tuple(starts) if starts is not None else (0,) * len(dims)
    data = array if isinstance(array, torch.Tensor) else np.asarray(array)
    dom = Domain(
        tuple(
            NamedRange(d, UnitRange(s, s + n))
            for d, s, n in zip(dims, starts, data.shape)
        )
    )
    return as_field(dom, data, device=device)


def connectivity_from_numpy(
    table: Any,
    domain_dims: Sequence[DimSpec],
    codomain: DimSpec,
    *,
    skip_value: Optional[int] = None,
    device: Any = None,
) -> Connectivity:
    """A port connectivity holding ``table`` (source × neighbour indices
    into ``codomain``), on ``device`` (default: the card)."""
    from gt4py_tpu_torch.next.constructors import as_connectivity

    return as_connectivity(
        tuple(as_dimension(d) for d in domain_dims),
        as_dimension(codomain),
        np.asarray(table),
        skip_value=skip_value,
        device=device,
    )
