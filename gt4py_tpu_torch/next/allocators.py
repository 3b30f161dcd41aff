"""Field buffer allocators.

Counterpart of gt4py_tpu/next/allocators.py (and of the reference's
``gt4py.next.custom_layout_allocators``,
src/gt4py/next/custom_layout_allocators.py:35,191,236): an allocator
decides the device and the physical layout of new field buffers. Every
allocator here hands out a torch tensor in the logical order of the
field's dimensions, seen through a permuted view of a buffer whose
vertical dimension leads: a field over (I, J, K) lives in a ``(K, I, J)``
buffer with J contiguous, the layout of the port's storages
(storage/layout.py), so the Hopper kernels' J-walking threads read
neighbouring addresses.
"""

from __future__ import annotations

from typing import Any, Optional, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from gt4py_tpu_torch.core.ndarray_utils import torch_dtype


@runtime_checkable
class FieldBufferAllocatorProtocol(Protocol):
    """Reference FieldBufferAllocatorProtocol (custom_layout_allocators.py:35).
    ``layout``: the physical order of the logical axes, outermost first
    (None: as given)."""

    def allocate(
        self, shape: Sequence[int], dtype: Any, layout: Optional[Sequence[int]] = None
    ) -> Any: ...


def empty_in_layout(
    shape: Sequence[int], dtype: Any, device: Any, layout: Optional[Sequence[int]] = None
) -> torch.Tensor:
    """An uninitialised tensor of ``shape`` (logical order) on ``device``,
    allocated in the physical order ``layout`` and returned as the view in
    logical order."""
    shape = tuple(int(n) for n in shape)
    layout = tuple(range(len(shape))) if layout is None else tuple(layout)
    buf = torch.empty(
        [shape[i] for i in layout], dtype=torch_dtype(dtype), device=device
    )
    return buf.permute(tuple(np.argsort(layout)))


class TorchFieldBufferAllocator:
    """Zero-filled buffers on one torch device."""

    def __init__(self, device: Any):
        self.device = torch.device(device)

    def allocate(
        self, shape: Sequence[int], dtype: Any, layout: Optional[Sequence[int]] = None
    ) -> torch.Tensor:
        return empty_in_layout(shape, dtype, self.device, layout).zero_()


class CPUFieldBufferAllocator(TorchFieldBufferAllocator):
    """Host buffers (reference StandardCPUFieldBufferAllocator, :191),
    ``alignment``-byte aligned by the native allocator (core/native.py)
    as the JAX package's are."""

    def __init__(self, alignment: int = 64):
        super().__init__("cpu")
        self.alignment = alignment

    def allocate(
        self, shape: Sequence[int], dtype: Any, layout: Optional[Sequence[int]] = None
    ) -> torch.Tensor:
        from gt4py_tpu_torch.core.native import aligned_empty

        shape = tuple(int(n) for n in shape)
        layout = tuple(range(len(shape))) if layout is None else tuple(layout)
        dtype = torch_dtype(dtype)
        physical = [shape[i] for i in layout]
        nbytes = int(np.prod(physical)) * dtype.itemsize
        raw = torch.from_numpy(aligned_empty((nbytes,), np.uint8, alignment=self.alignment))
        buf = raw.view(dtype).reshape(physical).zero_()
        return buf.permute(tuple(np.argsort(layout)))


class CUDAFieldBufferAllocator(TorchFieldBufferAllocator):
    """Buffers in the card's memory (reference's CUDA allocator, :236);
    ``device``: a CUDA device such as ``"cuda:1"``. Raises at allocation
    where there is no card: nothing falls back to the host."""

    def __init__(self, device: Any = "cuda"):
        super().__init__(device)


def device_allocator(device: Any = None) -> TorchFieldBufferAllocator:
    """Allocator for a device spec: None -> the card; ``"cpu"`` -> host
    buffers; any other torch device spec as given."""
    if device is None:
        return CUDAFieldBufferAllocator()
    if torch.device(device).type == "cpu":
        return CPUFieldBufferAllocator()
    return TorchFieldBufferAllocator(device)


DEFAULT_ALLOCATOR = CUDAFieldBufferAllocator()
