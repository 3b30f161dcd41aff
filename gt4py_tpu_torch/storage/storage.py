"""Device-resident storage for stencil fields.

Counterpart of gt4py_tpu/storage/storage.py. What stays from the JAX
package is the ``aligned_index`` ↦ *default origin* convention
(``__gt_origin__``) and the dimension annotations (``__gt_dims__``).

What changes: torch tensors are mutable, so stencils write into a
:class:`Storage`'s tensor in place, and there is no native-layout cache.
The tensor is an (I, J, K) view of a K-leading buffer (storage/layout.py),
so a kernel reads J contiguously. Assigning ``.array`` (as the JAX
package's setter does, an ndarray, a tensor or another storage) keeps the
storage on its device: a value of the same shape and dtype is copied into
the tensor it holds, whose pointer then stays valid for the launches and
CUDA graphs prepared on it; any other value gets a new K-leading tensor on
the same device. Nothing moves a storage between the CPU and the card.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from gt4py_tpu_torch.core.ndarray_utils import asnumpy, numpy_dtype
from gt4py_tpu_torch.storage import layout


class Storage:
    """Mutable ndarray-like wrapper around a ``torch.Tensor``."""

    __slots__ = ("_array", "aligned_index", "dimensions")

    def __init__(
        self,
        array: torch.Tensor,
        *,
        aligned_index: Optional[Sequence[int]] = None,
        dimensions: Optional[Sequence[str]] = None,
    ):
        if not isinstance(array, torch.Tensor):
            raise TypeError(f"Storage wraps a torch.Tensor, got {type(array).__name__}")
        self._array = array
        self.aligned_index = (
            tuple(int(i) for i in aligned_index) if aligned_index is not None else None
        )
        self.dimensions = tuple(dimensions) if dimensions is not None else None

    @property
    def array(self) -> torch.Tensor:
        return self._array

    @array.setter
    def array(self, value: Any) -> None:
        """Take ``value``'s content on this storage's device: copied into
        the tensor held where shape and dtype match (its pointer stays),
        else into a new K-leading tensor of ``value``'s shape and dtype."""
        if isinstance(value, Storage):
            value = value.array
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.array(value))
        held = self._array
        if value.shape == held.shape and value.dtype == held.dtype:
            held.copy_(value)
            return
        dims = self.dimensions if self.dimensions and len(self.dimensions) == value.ndim else None
        fresh = layout.allocate(tuple(value.shape), value.dtype, held.device, dims)
        fresh.copy_(value)
        self._array = fresh

    # -- gt4py interface (reference _core/definitions.py:363-376) -----------

    @property
    def __gt_origin__(self) -> tuple[int, ...]:
        return self.aligned_index or (0,) * self.array.ndim

    @property
    def __gt_dims__(self) -> Optional[tuple[str, ...]]:
        return self.dimensions

    # -- ndarray-like interface --------------------------------------------

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.array.shape)

    @property
    def dtype(self) -> np.dtype:
        return numpy_dtype(self.array.dtype)

    @property
    def device(self) -> torch.device:
        return self.array.device

    @property
    def ndim(self) -> int:
        return self.array.ndim

    @property
    def size(self) -> int:
        return self.array.numel()

    def __len__(self) -> int:
        return self.array.shape[0]

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        out = asnumpy(self.array)
        return out.astype(dtype) if dtype is not None else out

    def asnumpy(self) -> np.ndarray:
        return asnumpy(self.array)

    def __getitem__(self, idx) -> torch.Tensor:
        return self.array[idx]

    def __setitem__(self, idx, value) -> None:
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value), device=self.array.device)
        self.array[idx] = value

    def copy(self) -> "Storage":
        """A new storage with the same layout (strides) and content."""
        return Storage(
            torch.empty_like(self.array).copy_(self.array),
            aligned_index=self.aligned_index,
            dimensions=self.dimensions,
        )

    def __repr__(self) -> str:
        return (
            f"Storage(shape={self.shape}, dtype={self.dtype}, "
            f"device={self.device}, aligned_index={self.aligned_index})"
        )

    def __eq__(self, other) -> torch.Tensor:
        """Elementwise, as the JAX package's storage compares (a bool tensor
        on this storage's device)."""
        return self.array == self._operand(other)

    def __ne__(self, other) -> torch.Tensor:
        return self.array != self._operand(other)

    def _operand(self, other) -> Any:
        if isinstance(other, Storage):
            return other.array
        if isinstance(other, torch.Tensor):
            return other
        return torch.as_tensor(np.asarray(other), device=self.array.device)

    def __hash__(self):
        return id(self)
