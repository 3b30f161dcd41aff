"""Layout descriptors and per-backend layout registry.

Counterpart of gt4py_tpu/storage/layout.py (and of the reference's
``gt4py.storage.cartesian.layout``, src/gt4py/storage/cartesian/layout.py:21):
each backend registers a ``LayoutInfo`` saying on which device its storages
live by default and how the logical axes map to the physical order;
``storage.empty(..., backend=...)`` consults the registry.

The port's registry is its own: nothing here is registered into
``gt4py_tpu``'s. Every backend allocates K-leading ``(K, I, J)`` buffers with
J contiguous, so neighbouring CUDA threads (``threadIdx.x`` along J) read
neighbouring addresses, the ``cpu:c`` loop nest's inner J loop walks
contiguous memory, and a storage passes between all five backends as it
is; the public array order stays (I, J, K). ``torch`` and ``cuda:hopper``
allocate on the card; ``numpy``, ``debug`` and ``cpu:c`` on the CPU, so
naming one of these is how a caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class LayoutInfo:
    """Reference LayoutInfo TypedDict (layout.py:21) as a frozen dataclass."""

    alignment: int  # bytes; kept for API parity (torch's allocator aligns)
    device: str  # default torch device type: "cpu" | "cuda"
    layout_map: tuple[int, ...]  # per logical axis (I, J, K): physical order rank
    is_optimal_layout: bool = True

    def physical_order(self, dimensions: Sequence[str] = ("I", "J", "K")) -> tuple[int, ...]:
        """Axis permutation from logical to physical (minor last)."""
        order = sorted(range(len(self.layout_map)), key=lambda i: self.layout_map[i])
        return tuple(order)


REGISTRY: dict[str, LayoutInfo] = {}


def register(backend_name: str, info: LayoutInfo) -> None:
    """Register a backend's layout (reference layout_registry.py:23)."""
    REGISTRY[backend_name] = info


def from_name(backend_name: str) -> Optional[LayoutInfo]:
    return REGISTRY.get(backend_name)


_DEFAULT_DIMS = {1: ("I",), 2: ("I", "J"), 3: ("I", "J", "K")}


def physical_perm(ndim: int, dimensions: Optional[Sequence[str]]) -> list[int]:
    """Logical axes in allocation order: K first, then I and J, then data
    dimensions (innermost), each group in logical order."""
    dims = tuple(dimensions) if dimensions is not None else _DEFAULT_DIMS.get(ndim)
    if dims is None:  # more than 3 axes and no annotation: I, J, K, data...
        dims = ("I", "J", "K") + tuple(str(d) for d in range(ndim - 3))
    spatial = [i for i, d in enumerate(dims) if d in ("I", "J")]
    k = [i for i, d in enumerate(dims) if d == "K"]
    data = [i for i, d in enumerate(dims) if d not in ("I", "J", "K")]
    return k + spatial + data


def allocate(
    shape: Sequence[int],
    dtype: torch.dtype,
    device: torch.device,
    dimensions: Optional[Sequence[str]] = None,
    fill: Any = None,
) -> torch.Tensor:
    """A logical-order view of a K-leading buffer on ``device``; filled
    with ``fill`` unless it is None (the caller fills it)."""
    perm = physical_perm(len(shape), dimensions)
    phys_shape = tuple(shape[p] for p in perm)
    if fill is None:
        buf = torch.empty(phys_shape, dtype=dtype, device=device)
    else:
        buf = torch.full(phys_shape, fill, dtype=dtype, device=device)
    inverse = [perm.index(a) for a in range(len(shape))]
    return buf.permute(*inverse)


# K major, then I, then J (minor): layout_map gives each of (I, J, K) its rank.
_KIJ = (1, 2, 0)

register("torch", LayoutInfo(alignment=64, device="cuda", layout_map=_KIJ))
register("cuda:hopper", LayoutInfo(alignment=128, device="cuda", layout_map=_KIJ))
register("numpy", LayoutInfo(alignment=64, device="cpu", layout_map=_KIJ))
register("debug", LayoutInfo(alignment=1, device="cpu", layout_map=_KIJ))
register("cpu:c", LayoutInfo(alignment=64, device="cpu", layout_map=_KIJ))
