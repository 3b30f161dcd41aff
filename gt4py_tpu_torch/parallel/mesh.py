"""Device mesh for multi-device stencil execution.

Counterpart of gt4py_tpu/parallel/mesh.py. The JAX package lays a 2-D
``jax.sharding.Mesh`` over ``jax.devices()`` in one controlling process;
this module does the same over a list of ``torch.device``s. A device may
appear more than once: ``[torch.device("cpu")] * 8`` is the port's
counterpart of JAX's eight virtual CPU devices, and ``[cuda:0] * 4`` runs
four shards, and the real halo exchange between them, on one card. On
several cards the same code copies between peers (halo.py says how those
copies are ordered, and which test holds them against one card).

The slice logic is kept whole (``slice_indices=``, the slice-major layout,
``dcn_boundaries``, ``slice_of``, ``is_intra_slice``): torch devices carry
no slice index or torus coordinates, so the indices come from the caller,
and devices keep their given order inside a slice.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch


class CartesianMesh:
    """2-D (x, y) device mesh for IJ domain decomposition.

    ``devices`` defaults to every visible card (``torch.cuda.device_count()``);
    without one it raises, it never falls back to the CPU. ``slice_indices``
    groups the devices into slices (multi-slice layouts on a virtual mesh).
    """

    def __init__(
        self,
        devices: Optional[Sequence] = None,
        shape: Optional[tuple[int, int]] = None,
        *,
        slice_indices: Optional[Sequence[int]] = None,
    ):
        if devices is None:
            count = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if count == 0:
                raise RuntimeError(
                    "CartesianMesh() lays the mesh over the visible CUDA cards and finds "
                    "none; pass devices=[torch.device('cpu')] * n for a mesh on the CPU"
                )
            devices = [torch.device("cuda", i) for i in range(count)]
        devices = [torch.device(d) if not isinstance(d, torch.device) else d for d in devices]
        n = len(devices)

        if slice_indices is None:
            slice_indices = [getattr(d, "slice_index", 0) or 0 for d in devices]
        if len(slice_indices) != n:
            raise ValueError(f"{len(slice_indices)} slice indices for {n} devices")
        self.slice_indices = list(slice_indices)
        groups: dict[int, list] = {}
        for d, s in zip(devices, slice_indices):
            groups.setdefault(int(s), []).append(d)
        sizes = {len(g) for g in groups.values()}
        self.n_slices = len(groups)

        if self.n_slices > 1 and len(sizes) == 1:
            # Equal slices: x axis is slice-major — slice s owns x rows
            # [s*sx, (s+1)*sx); halo partners along y and along x inside a
            # slice stay in the slice, only the x rows at slice boundaries
            # cross between slices.
            per = sizes.pop()
            sx, sy = _factor2(per)
            if shape is not None:
                if shape[0] % self.n_slices != 0:
                    raise ValueError(
                        f"Mesh shape {shape} cannot distribute {self.n_slices} slices along x"
                    )
                sx, sy = shape[0] // self.n_slices, shape[1]
                if sx * sy != per:
                    raise ValueError(
                        f"Mesh shape {shape} does not match {self.n_slices} slices of "
                        f"{per} devices"
                    )
            ordered: list = []
            for s in sorted(groups):
                ordered.extend(_ici_order(groups[s]))
            self._slice_grouped = True
            self._slice_rows = sx
            self.shape = (self.n_slices * sx, sy)
        else:
            # Single slice (or irregular slice sizes: the flat layout, still
            # correct, just not minimal in slice crossings).
            if shape is None:
                shape = _factor2(n)
            if shape[0] * shape[1] != n:
                raise ValueError(f"Mesh shape {shape} does not match {n} devices")
            self._slice_grouped = False
            self._slice_rows = shape[0]
            ordered = _ici_order(devices)
            self.shape = tuple(shape)
        grid = np.empty(n, dtype=object)
        grid[:] = ordered
        #: the torch devices as laid out on the mesh (row-major (x, y))
        self.device_grid = grid.reshape(self.shape)

    @property
    def nx(self) -> int:
        return self.shape[0]

    @property
    def ny(self) -> int:
        return self.shape[1]

    @property
    def devices(self) -> list[torch.device]:
        """The devices in shard order: shard ``x * ny + y`` is at (x, y)."""
        return list(self.device_grid.ravel())

    def dcn_boundaries(self) -> list[int]:
        """x indices whose +x halo partner lives on ANOTHER slice: the
        exchange between x row i and i+1 crosses slices iff i is listed
        (plus the periodic x wrap nx-1 -> 0 on multi-slice meshes)."""
        if not self._slice_grouped:
            return []
        rows = [i * self._slice_rows - 1 for i in range(1, self.n_slices)]
        rows.append(self.nx - 1)  # periodic wrap crosses slices too
        return rows

    def slice_of(self, x: int, y: int) -> int:
        """Slice index of the device at mesh position (x, y)."""
        if not self._slice_grouped:
            return 0
        return x // self._slice_rows

    def is_intra_slice(self, axis: str, index: int) -> bool:
        """Whether the halo exchange from mesh row/col ``index`` to
        ``index + 1`` along ``axis`` ('x' | 'y') stays inside one slice."""
        if axis == "y" or not self._slice_grouped:
            return True
        return (index % self._slice_rows) != self._slice_rows - 1

    def sharding(self, spec: Sequence = ("x", "y", None)):
        """The placement of an array split over this mesh by ``spec`` (the
        counterpart of a ``NamedSharding``)."""
        from gt4py_tpu_torch.parallel.sharded import Placement

        return Placement(self, spec)

    def shard_ij(self, array):
        """Place a global (I, J, K) array (NumPy or tensor) split over the
        mesh: a :class:`~gt4py_tpu_torch.parallel.sharded.ShardedArray`."""
        from gt4py_tpu_torch.parallel.sharded import scatter

        return scatter(array, self.sharding())

    def __repr__(self) -> str:
        return f"CartesianMesh(shape={self.shape}, devices={self.devices})"


def _ici_order(devices: Sequence) -> list:
    """Order devices inside one slice by torus coordinates (z, y, x) where
    they carry them; devices without coordinates (every torch device) keep
    their given order."""

    def key(item):
        i, d = item
        c = getattr(d, "coords", None)
        if c is None:
            return (0, i)
        return (1, tuple(reversed(tuple(c))), getattr(d, "core_on_chip", 0))

    return [d for _, d in sorted(enumerate(devices), key=key)]


def _factor2(n: int) -> tuple[int, int]:
    """Most-square factorization of n (balanced exchange traffic)."""
    best = (1, n)
    for a in range(1, int(math.isqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best
