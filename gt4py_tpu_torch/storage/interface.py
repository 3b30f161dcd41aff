"""Storage allocation interface.

Counterpart of gt4py_tpu/storage/interface.py, with the same signatures
(``shape, dtype, *, backend, aligned_index, dimensions``) plus an explicit
``device=``. The default device comes from the backend's layout
(storage/layout.py): ``"cuda"`` for ``torch`` and ``cuda:hopper`` — where
torch raises if there is no card, with no CPU fallback — and ``"cpu"`` for
``numpy``, ``debug`` and ``cpu:c``.

Buffers are allocated K-leading, (K, I, J) with J contiguous, and returned
as an (I, J, K) view. :func:`from_array` is how the JAX package's state
(a ``gt4py_tpu`` ``Storage`` or any ``__array__`` object) enters the port.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from gt4py_tpu_torch.core.definitions import is_float_dtype
from gt4py_tpu_torch.core.ndarray_utils import numpy_dtype, torch_dtype
from gt4py_tpu_torch.storage import layout
from gt4py_tpu_torch.storage.storage import Storage

def _validate(shape, aligned_index, dimensions, backend) -> None:
    if layout.from_name(backend) is None:
        raise ValueError(
            f"Unknown backend '{backend}' (expected one of {sorted(layout.REGISTRY)})"
        )
    if aligned_index is not None:
        if len(aligned_index) != len(shape):
            raise ValueError(
                f"'aligned_index' ({aligned_index}) does not match shape {shape}"
            )
        if any(i < 0 for i in aligned_index):
            raise ValueError(f"'aligned_index' must be non-negative, got {aligned_index}")
    if dimensions is not None and len(dimensions) != len(shape):
        raise ValueError(f"'dimensions' ({dimensions}) does not match shape {shape}")


def _allocate(shape, dtype, backend, dimensions, device, fill) -> torch.Tensor:
    info = layout.from_name(backend)
    dev = torch.device(device if device is not None else info.device)
    return layout.allocate(shape, torch_dtype(dtype), dev, dimensions, fill)


def empty(
    shape: Sequence[int],
    dtype: Any = np.float64,
    *,
    backend: str = "torch",
    aligned_index: Optional[Sequence[int]] = None,
    dimensions: Optional[Sequence[str]] = None,
    device: Any = None,
) -> Storage:
    """Allocate a storage. Zero-filled, like the JAX package's (which has
    no uninitialized allocation); with ``GT4PY_DEBUG_POISON_EMPTY=1`` the
    fill is NaN (floats) or the dtype's max (ints) instead, so unread or
    out-of-domain cells stand out."""
    import os

    if os.environ.get("GT4PY_DEBUG_POISON_EMPTY", "0") not in ("0", "", "false"):
        dt = numpy_dtype(dtype)
        if is_float_dtype(dt):
            fill: Any = float("nan")
        elif dt.kind in ("i", "u"):
            fill = np.iinfo(dt).max
        else:
            fill = True
        return full(
            shape, fill, dtype, backend=backend, aligned_index=aligned_index,
            dimensions=dimensions, device=device,
        )
    return zeros(
        shape, dtype, backend=backend, aligned_index=aligned_index,
        dimensions=dimensions, device=device,
    )


def zeros(
    shape: Sequence[int],
    dtype: Any = np.float64,
    *,
    backend: str = "torch",
    aligned_index: Optional[Sequence[int]] = None,
    dimensions: Optional[Sequence[str]] = None,
    device: Any = None,
) -> Storage:
    return full(
        shape, 0, dtype, backend=backend, aligned_index=aligned_index,
        dimensions=dimensions, device=device,
    )


def ones(
    shape: Sequence[int],
    dtype: Any = np.float64,
    *,
    backend: str = "torch",
    aligned_index: Optional[Sequence[int]] = None,
    dimensions: Optional[Sequence[str]] = None,
    device: Any = None,
) -> Storage:
    return full(
        shape, 1, dtype, backend=backend, aligned_index=aligned_index,
        dimensions=dimensions, device=device,
    )


def full(
    shape: Sequence[int],
    fill_value: Any,
    dtype: Any = np.float64,
    *,
    backend: str = "torch",
    aligned_index: Optional[Sequence[int]] = None,
    dimensions: Optional[Sequence[str]] = None,
    device: Any = None,
) -> Storage:
    shape = tuple(int(s) for s in shape)
    _validate(shape, aligned_index, dimensions, backend)
    return Storage(
        _allocate(shape, dtype, backend, dimensions, device, fill_value),
        aligned_index=aligned_index,
        dimensions=dimensions,
    )


def from_array(
    data: Any,
    dtype: Any = None,
    *,
    backend: str = "torch",
    aligned_index: Optional[Sequence[int]] = None,
    dimensions: Optional[Sequence[str]] = None,
    device: Any = None,
) -> Storage:
    """Copy ``data`` (a tensor, a NumPy array or anything with
    ``__array__``, such as a ``gt4py_tpu`` Storage) into a new storage.
    ``aligned_index`` and ``dimensions`` default to the source's
    ``__gt_origin__`` and ``__gt_dims__``. A bfloat16 ``dtype`` (which
    NumPy cannot hold) rounds NumPy data to nearest even through torch."""
    if aligned_index is None:
        aligned_index = getattr(data, "__gt_origin__", None)
    if dimensions is None:
        dimensions = getattr(data, "__gt_dims__", None)
    if isinstance(data, Storage):
        data = data.array
    if isinstance(data, torch.Tensor):
        src = data if dtype is None else data.to(torch_dtype(dtype))
    elif dtype is not None and torch_dtype(dtype) == torch.bfloat16:
        src = torch.from_numpy(np.array(data)).to(torch.bfloat16)
    else:
        array = np.ascontiguousarray(data if dtype is None else np.asarray(data, dtype=dtype))
        if not array.flags.writeable:  # torch.from_numpy wants a writable buffer
            array = array.copy()
        src = torch.from_numpy(array)
    shape = tuple(src.shape)
    _validate(shape, aligned_index, dimensions, backend)
    out = _allocate(shape, src.dtype, backend, dimensions, device, None)
    out.copy_(src)
    return Storage(out, aligned_index=aligned_index, dimensions=dimensions)
