"""Placements and sharded arrays over a :class:`CartesianMesh`.

The port's counterpart of a ``jax.Array`` placed with a ``NamedSharding``
(gt4py_tpu/parallel/mesh.py:138-144). PyTorch has no global array type
spread over devices, so the port keeps one block per shard, each a tensor
on its shard's device:

- :class:`Placement` is the ``NamedSharding``: the mesh and a spec naming,
  for each array axis, the mesh axis it is split over ('x' or 'y') or None
  (the axis is whole in every block);
- :class:`ShardedArray` holds the blocks, in shard order, and the global
  shape; ``numpy()`` (and ``np.asarray``) assembles the global array on the
  host, :meth:`ShardedArray.assemble` on a device. The blocks of a
  ``DistributedStencil`` result are views of the interiors of its
  halo-extended buffers, which a later step takes as they are.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from gt4py_tpu_torch.core.ndarray_utils import asnumpy, numpy_dtype
from gt4py_tpu_torch.storage import layout


class Placement:
    """Where an array's blocks live: ``spec[a]`` is the mesh axis ('x' or
    'y') that array axis ``a`` is split over, or None; axes beyond the spec
    are whole."""

    def __init__(self, mesh, spec: Sequence = ("x", "y", None)):
        self.mesh = mesh
        self.spec = tuple(spec)
        for axis in self.spec:
            if axis not in ("x", "y", None):
                raise ValueError(f"placement spec names '{axis}', not a mesh axis ('x', 'y')")

    def parts(self, axis: Optional[str]) -> int:
        """Shards an array axis placed on mesh axis ``axis`` is split into."""
        return {"x": self.mesh.nx, "y": self.mesh.ny, None: 1}[axis]

    def axes(self, ndim: int) -> tuple:
        """The spec padded with None to ``ndim`` array axes."""
        if len(self.spec) > ndim:
            raise ValueError(f"placement spec {self.spec} has more axes than {ndim}")
        return self.spec + (None,) * (ndim - len(self.spec))

    def shard_shape(self, global_shape: Sequence[int]) -> tuple[int, ...]:
        """One block's shape for an array of ``global_shape``."""
        return tuple(
            -(-int(n) // self.parts(a)) for n, a in zip(global_shape, self.axes(len(global_shape)))
        )

    @property
    def is_fully_replicated(self) -> bool:
        """Every block holds the whole array."""
        return all(self.parts(a) == 1 for a in self.spec)

    def coords(self, shard: int, axis: Optional[str]) -> int:
        """The position of ``shard`` along mesh axis ``axis`` (0 for None)."""
        x, y = divmod(shard, self.mesh.ny)
        return {"x": x, "y": y, None: 0}[axis]

    def block_index(self, shard: int, block_shape: Sequence[int]) -> tuple:
        """The slices of the (padded) global array that ``shard`` holds."""
        axes = self.axes(len(block_shape))
        return tuple(
            slice(self.coords(shard, a) * b, (self.coords(shard, a) + 1) * b)
            for a, b in zip(axes, block_shape)
        )

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Placement) and other.mesh is self.mesh and other.spec == self.spec
        )

    def __repr__(self) -> str:
        return f"Placement(mesh={self.mesh.shape}, spec={self.spec})"


class ShardedArray:
    """A global array held as one block per shard of a mesh.

    ``blocks[s]`` lives on ``sharding.mesh.devices[s]``. The blocks tile the
    padded global array (the global shape rounded up to the mesh, with
    ``lead`` cells in front of the data along each axis); ``shape`` is the
    global shape of the data. ``buffers`` and ``halo`` are set where each
    block is the interior of a halo-extended buffer (a ``DistributedStencil``
    result): ``halo`` = (i_lo, i_hi, j_lo, j_hi) cells around the block.
    """

    def __init__(
        self,
        blocks: list,
        sharding: Placement,
        shape: Sequence[int],
        *,
        lead: Optional[Sequence[int]] = None,
        buffers: Optional[list] = None,
        halo: Optional[tuple] = None,
    ):
        if len(blocks) != len(sharding.mesh.devices):
            raise ValueError(f"{len(blocks)} blocks for a mesh of {sharding.mesh.shape}")
        self.blocks = list(blocks)
        self.sharding = sharding
        self.shape = tuple(int(n) for n in shape)
        self.lead = tuple(lead) if lead is not None else (0,) * len(self.shape)
        self.buffers = buffers
        self.halo = halo

    @property
    def dtype(self) -> np.dtype:
        return numpy_dtype(self.blocks[0].dtype)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def is_fully_replicated(self) -> bool:
        return self.sharding.is_fully_replicated

    def assemble(self, device: Any = None) -> torch.Tensor:
        """The global array as one tensor on ``device`` (default: the first
        shard's): the blocks joined along the split axes, the padding cut."""
        device = torch.device(device) if device is not None else self.blocks[0].device
        mesh = self.sharding.mesh
        axes = self.sharding.axes(self.ndim)
        grid = [[self.blocks[x * mesh.ny + y] for y in range(mesh.ny)] for x in range(mesh.nx)]
        if "y" in axes:
            rows = [torch.cat([b.to(device) for b in row], dim=axes.index("y")) for row in grid]
        else:
            rows = [row[0].to(device) for row in grid]
        full = torch.cat(rows, dim=axes.index("x")) if "x" in axes else rows[0]
        return full[tuple(slice(lo, lo + n) for lo, n in zip(self.lead, self.shape))]

    def numpy(self) -> np.ndarray:
        return asnumpy(self.assemble("cpu"))

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        out = self.numpy()
        return out.astype(dtype) if dtype is not None else out

    def map_blocks(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "ShardedArray":
        """``fn`` applied to every block on its device (an elementwise
        operation keeps the placement, as a jitted one does on a
        ``jax.Array``)."""
        return ShardedArray(
            [fn(b) for b in self.blocks], self.sharding, self.shape, lead=self.lead
        )

    def __repr__(self) -> str:
        return (
            f"ShardedArray(shape={self.shape}, dtype={self.dtype}, "
            f"block={tuple(self.blocks[0].shape)}, sharding={self.sharding})"
        )


def empty_block(shape: Sequence[int], dtype: torch.dtype, device, dims=None) -> torch.Tensor:
    """A block laid out as a storage is (storage/layout.py): K leading, J
    contiguous; ``dims`` names its axes ("I", "J", "K" or a data axis)."""
    return layout.allocate(tuple(shape), dtype, torch.device(device), dims)


def scatter(array: Any, sharding: Placement) -> ShardedArray:
    """Split a global array (NumPy, tensor or Storage) into the blocks of
    ``sharding``, each copied onto its shard's device; the global shape must
    divide evenly."""
    from gt4py_tpu_torch.cartesian.backend.base import as_tensor

    tensor = as_tensor(array)
    block_shape = sharding.shard_shape(tensor.shape)
    if any(
        b * sharding.parts(a) != n
        for a, b, n in zip(sharding.axes(tensor.ndim), block_shape, tensor.shape)
    ):
        raise ValueError(
            f"shape {tuple(tensor.shape)} does not split evenly over the mesh {sharding.mesh.shape}"
        )
    blocks = []
    for s, device in enumerate(sharding.mesh.devices):
        block = empty_block(block_shape, tensor.dtype, device)
        block.copy_(tensor[sharding.block_index(s, block_shape)])
        blocks.append(block)
    return ShardedArray(blocks, sharding, tensor.shape)
