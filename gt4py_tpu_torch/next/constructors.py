"""Field/connectivity constructors (reference: gt4py.next.constructors,
src/gt4py/next/constructors.py:394-611).

Counterpart of gt4py_tpu/next/constructors.py. Every constructor puts its
buffer on the card unless the caller passes ``device="cpu"`` (or another
torch device, or an ``allocator``), and lays a field out with its vertical
dimension leading (allocators.py).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from gt4py_tpu_torch.core.ndarray_utils import numpy_dtype, torch_dtype
from gt4py_tpu_torch.next.common import (
    Connectivity,
    Dimension,
    DimensionKind,
    Domain,
    NamedRange,
    UnitRange,
    domain as make_domain,
)
from gt4py_tpu_torch.next.embedded import Field


def _norm_dtype(dtype: Any) -> np.dtype:
    # Identity checks: ``np.dtype('float64') == float`` is True in numpy,
    # so a membership test would send dtype OBJECTS into the builtin map.
    if dtype is int or dtype is float or dtype is bool:
        return np.dtype({int: np.int64, float: np.float64, bool: np.bool_}[dtype])
    if dtype is None:
        return np.dtype(np.float64)
    return numpy_dtype(dtype)


def layout(dims: Sequence[Dimension]) -> tuple[int, ...]:
    """The physical order of a field's axes, outermost first: its vertical
    dimensions, then the others in order. (I, J, K) -> (K, I, J)."""
    vertical = [i for i, d in enumerate(dims) if d.kind == DimensionKind.VERTICAL]
    return tuple(vertical + [i for i in range(len(dims)) if i not in vertical])


def _resolve_allocator(allocator, device):
    """Allocator precedence: explicit allocator > device spec > the card
    (reference allocator protocol, constructors.py:394 +
    custom_layout_allocators.py:35)."""
    from gt4py_tpu_torch.next import allocators as _alloc

    if allocator is not None:
        return allocator
    return _alloc.device_allocator(device)


def _allocate(dom: Domain, dtype: Any, allocator, device) -> torch.Tensor:
    alloc = _resolve_allocator(allocator, device)
    return alloc.allocate(dom.shape, _norm_dtype(dtype), layout=layout(dom.dims))


def empty(domain_spec, dtype: Any = np.float64, *, allocator=None, device=None) -> Field:
    return zeros(domain_spec, dtype, allocator=allocator, device=device)


def zeros(domain_spec, dtype: Any = np.float64, *, allocator=None, device=None) -> Field:
    dom = make_domain(domain_spec)
    return Field(dom, _allocate(dom, dtype, allocator, device))


def ones(domain_spec, dtype: Any = np.float64, *, allocator=None, device=None) -> Field:
    return full(domain_spec, 1, dtype, allocator=allocator, device=device)


def full(
    domain_spec, fill_value: Any, dtype: Any = None, *, allocator=None, device=None
) -> Field:
    dom = make_domain(domain_spec)
    if dtype is None:
        # the fill value's own type, Python numbers as 64-bit types
        dtype = np.asarray(fill_value).dtype
    arr = _allocate(dom, dtype, allocator, device)
    return Field(dom, arr.fill_(fill_value))


def as_field(
    domain_spec: Union[Domain, Sequence[Dimension], dict],
    data: Any,
    dtype: Any = None,
    *,
    origin: Optional[dict] = None,
    allocator=None,
    device=None,
) -> Field:
    """A Field holding a copy of ``data`` (a NumPy array, array-like or
    tensor), laid out with its vertical dimension leading, on the card
    unless ``device`` says otherwise (reference constructors.py:394). When
    ``domain_spec`` is a sequence of Dimensions the ranges come from the
    array shape (optionally offset by ``origin``)."""
    if not isinstance(data, torch.Tensor):
        host = np.asarray(data)
        # a read-only array (a JAX array read out) is copied here anyway
        data = torch.as_tensor(host if host.flags.writeable else host.copy())
    if dtype is not None:
        data = data.to(torch_dtype(_norm_dtype(dtype)))
    if isinstance(domain_spec, (Domain, dict)):
        dom = make_domain(domain_spec)
    else:
        dims = tuple(domain_spec)
        from gt4py_tpu_torch.next.common import check_dims

        check_dims(dims)
        origin = origin or {}
        ranges = []
        for d, size in zip(dims, data.shape):
            start = -origin.get(d, 0)
            ranges.append(NamedRange(d, UnitRange(start, start + size)))
        dom = Domain(tuple(ranges))
    arr = _allocate(dom, data.dtype, allocator, device)
    if tuple(data.shape) != tuple(arr.shape):
        raise ValueError(f"Array shape {tuple(data.shape)} does not match domain {dom}")
    arr.copy_(data)
    return Field(dom, arr)


def as_connectivity(
    domain_dims: Sequence[Dimension],
    codomain: Dimension,
    data: Any,
    *,
    skip_value: Optional[int] = None,
    allocator=None,
    device=None,
) -> Connectivity:
    """Build a neighbor table (reference constructors.py:529), on the card
    unless ``device`` (or ``allocator``) says otherwise."""
    dims = tuple(domain_dims)
    if len(dims) != 2:
        raise ValueError("Connectivity requires (source_dim, neighbor_dim)")
    table = data if isinstance(data, torch.Tensor) else torch.as_tensor(np.asarray(data))
    alloc = _resolve_allocator(allocator, device)
    buf = alloc.allocate(tuple(table.shape), numpy_dtype(table.dtype))
    buf.copy_(table)
    return Connectivity(buf, domain_dims=dims, codomain=codomain, skip_value=skip_value)
