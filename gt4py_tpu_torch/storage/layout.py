"""Layout descriptors and per-backend layout registry.

Counterpart of gt4py_tpu/storage/layout.py (and of the reference's
``gt4py.storage.cartesian.layout``, src/gt4py/storage/cartesian/layout.py:21):
each backend registers a ``LayoutInfo`` saying on which device its storages
live by default and how the logical axes map to the physical order;
``storage.empty(..., backend=...)`` consults the registry.

The port's registry is its own: nothing here is registered into
``gt4py_tpu``'s. Both backends allocate K-leading ``(K, I, J)`` buffers with
J contiguous, so neighbouring CUDA threads (``threadIdx.x`` along J) read
neighbouring addresses; the public array order stays (I, J, K).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


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


# K major, then I, then J (minor): layout_map gives each of (I, J, K) its rank.
_KIJ = (1, 2, 0)

register("torch", LayoutInfo(alignment=64, device="cuda", layout_map=_KIJ))
register("cuda:hopper", LayoutInfo(alignment=128, device="cuda", layout_map=_KIJ))
