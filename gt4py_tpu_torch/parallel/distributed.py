"""Multi-device stencil execution: IJ domain decomposition over a mesh.

Counterpart of gt4py_tpu/parallel/distributed.py. There a compiled stencil
is lifted to SPMD with ``shard_map``: each device owns an (ni/nx, nj/ny, nk)
block, halos move with ``lax.ppermute`` and the single-device evaluator (or
the Pallas kernels) runs on the halo-extended local block, all in one jitted
program. Here one controller drives every shard in turn:

1. each field's blocks live in halo-extended buffers, one per shard on its
   shard's device, laid out as a storage is (K leading, J contiguous); a
   global array is scattered into them once per call, and a
   :class:`~gt4py_tpu_torch.parallel.sharded.ShardedArray` from an earlier
   step is taken as it is;
2. the exchange (halo.py) copies the neighbours' edge slabs into the halos,
   in place;
3. each shard runs ``stencil._backend.run`` on its buffers over its local
   domain: on CUDA tensors ``cuda:hopper`` launches the kernel its
   ``strategy`` names (``plane`` for hdiff, ``column`` for vadv and
   tridiag), on CPU tensors the plain version runs;
4. the written fields come back as sharded arrays whose blocks are views of
   the buffers' interiors: nothing is copied to trim.

On one card every shard's kernels and the exchange copies run on one
stream, one after the other; on several, each shard's kernels run on its
card's current stream and the copies between cards are ordered with both
(halo.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from gt4py_tpu_torch.cartesian.backend.base import as_tensor, from_name
from gt4py_tpu_torch.cartesian.definitions import AccessKind
from gt4py_tpu_torch.core.ndarray_utils import torch_dtype
from gt4py_tpu_torch.parallel import halo as halo_exchange
from gt4py_tpu_torch.parallel.mesh import CartesianMesh
from gt4py_tpu_torch.parallel.sharded import Placement, ShardedArray, empty_block
from gt4py_tpu_torch.storage.storage import Storage


@dataclasses.dataclass
class _Role:
    """How one field of the stencil is split, padded and held."""

    name: str
    dtype: torch.dtype
    shape: tuple  # global, as the caller passes it
    spec: tuple  # per array axis: "x", "y" or None
    lead: tuple  # per array axis: padding cells in front of the data
    block: tuple  # one shard's share of the padded array
    buffer_halo: tuple  # (i_lo, i_hi, j_lo, j_hi) around a block in its buffer
    dims: tuple  # axis names for the K-leading allocation
    origin: tuple  # of the block in its buffer, (I, J, K)
    transfers: list  # the exchange filling this field's own halo

    @property
    def interior(self) -> tuple:
        i_lo, _, j_lo, _ = self.buffer_halo
        index = []
        for a, b in zip(self.spec, self.block):
            lo = i_lo if a == "x" else j_lo if a == "y" else 0
            index.append(slice(lo, lo + b))
        return tuple(index)

    @property
    def buffer_shape(self) -> tuple:
        i_lo, i_hi, j_lo, j_hi = self.buffer_halo
        extra = {"x": i_lo + i_hi, "y": j_lo + j_hi, None: 0}
        return tuple(b + extra[a] for a, b in zip(self.spec, self.block))


class _Layout:
    """The geometry of one call signature (field names and shapes)."""

    def __init__(self, dist: "DistributedStencil", field_names, shapes):
        infos = dist.field_infos
        mesh = dist.mesh
        self.mesh_devices = mesh.devices
        modes = (
            tuple(dist.boundary)
            if isinstance(dist.boundary, (tuple, list))
            else (dist.boundary, dist.boundary)
        )
        halos = {n: dist._halo(n) for n in field_names}
        size_of: dict[int, int] = {}
        for name, shape in zip(field_names, shapes):
            mask = infos[name].domain_mask
            ax = 0
            for axis_id in range(2):
                if mask[axis_id]:
                    size_of.setdefault(axis_id, shape[ax])
                    ax += 1
        halo_max = [
            (
                max((halos[n][2 * a] for n in field_names), default=0),
                max((halos[n][2 * a + 1] for n in field_names), default=0),
            )
            for a in range(2)
        ]
        self.plans = {}
        for axis_id, n_shards in ((0, mesh.nx), (1, mesh.ny)):
            if axis_id in size_of:
                self.plans[axis_id] = dist._axis_plan(
                    size_of[axis_id], n_shards, *halo_max[axis_id], modes[axis_id]
                )
        self.size_of = size_of
        self.modes = modes
        self.needs_pad = any(p[1] or p[2] for p in self.plans.values())
        # one halo for every (I, J) field's buffers, so that a result serves
        # any role of a later step as it is
        ij = [n for n in field_names if all(infos[n].domain_mask[:2])]
        buffer_halo = tuple(max((halos[n][c] for n in ij), default=0) for c in range(4))

        self.nk = None
        for name, shape in zip(field_names, shapes):
            if infos[name].domain_mask[2]:
                self.nk = shape[infos[name].domain_ndim - 1]
                break
        self.domain = None
        self.roles: dict[str, _Role] = {}
        for name, shape in zip(field_names, shapes):
            info = infos[name]
            mask = info.domain_mask
            spec, lead, padded = [], [], []
            for axis_id, axis in enumerate(("x", "y", None)):
                if not mask[axis_id]:
                    continue
                spec.append(axis)
                if axis is None:
                    lead.append(0)
                    padded.append(shape[len(spec) - 1])
                else:
                    p, lo, _ = self.plans[axis_id]
                    lead.append(lo)
                    padded.append(p)
            data = tuple(shape[len(spec):])
            spec += [None] * len(data)
            lead += [0] * len(data)
            padded += list(data)
            placement = Placement(mesh, spec)
            block = placement.shard_shape(padded)
            i_lo, i_hi, j_lo, j_hi = halos[name]
            if all(mask[:2]):
                bh = buffer_halo
                origin = (bh[0], bh[2], 0)
                transfers = (
                    halo_exchange.plan(mesh, block[:2], halos[name], bh, modes)
                    if any(halos[name])
                    else []
                )
                if mask[2] and self.domain is None:
                    self.domain = (block[0], block[1], self.nk)
            else:
                if (mask[0] and (i_lo or i_hi)) or (mask[1] and (j_lo or j_hi)):
                    raise ValueError(
                        f"field '{name}' is read at horizontal offsets but has no (I, J) "
                        "plane: its halo cannot be exchanged"
                    )
                bh, origin, transfers = (0, 0, 0, 0), (0, 0, 0), []
            self.roles[name] = _Role(
                name=name,
                dtype=torch_dtype(info.dtype),
                shape=tuple(shape),
                spec=tuple(spec),
                lead=tuple(lead),
                block=tuple(block),
                buffer_halo=bh,
                dims=tuple(info.axes) + tuple(str(d) for d in range(len(data))),
                origin=origin,
                transfers=transfers,
            )
        if self.domain is None:
            raise ValueError("a distributed stencil needs at least one (I, J, K) field")
        self.origins = {n: r.origin for n, r in self.roles.items()}
        #: buffers of the read-only roles, filled anew by every call
        self.read_buffers: dict[str, list] = {}

    def allocate(self, role: _Role) -> list:
        return [
            empty_block(role.buffer_shape, role.dtype, device, role.dims)
            for device in self.mesh_devices
        ]


class DistributedStencil:
    """SPMD wrapper around a compiled stencil.

    Usage::

        mesh = CartesianMesh([torch.device("cuda", 0)] * 4)
        dist = DistributedStencil(stencil_obj, mesh)
        out = dist.apply(field_a=a, field_b=b, scalar=1.0)   # dict of written

    Fields are global (NI, NJ, NK) arrays (NumPy, tensors or Storages) or
    the sharded arrays an earlier ``apply`` returned. NI/NJ need not be
    divisible by the mesh shape: uneven sizes are padded to the next mesh
    multiple (cyclic fill under periodic boundaries, edge/zero fill under
    clamp/zero) and the written outputs carry the padding as lead and trail
    cells of their blocks. ``boundary`` selects the global boundary condition
    ("periodic" / "clamp" / "zero"; one value or an (i, j) pair).
    ``backend`` selects the per-shard compute: ``cuda:hopper`` (the
    default for a ``cuda:hopper`` stencil: the Hopper kernels, or the plain
    version on CPU tensors) or ``torch`` (the plain version; the default
    otherwise), or any other registered cartesian backend.

    A written field given as a sharded array that matches the layout is
    written in place and returned; any other written field comes back in
    new buffers. ``last_strategy`` lists what served each shard in the last
    call ("plane", "column", ... or "plain").
    """

    def __init__(
        self,
        stencil,
        mesh: Optional[CartesianMesh] = None,
        *,
        boundary: Any = "periodic",
        backend: Optional[str] = None,
    ):
        self.stencil = stencil
        self.analyzed = stencil._analyzed
        self.mesh = mesh if mesh is not None else CartesianMesh()
        self.boundary = boundary
        halo_exchange._modes(boundary)
        self.backend = backend or (
            "cuda:hopper" if stencil.backend == "cuda:hopper" else "torch"
        )
        self._backend = (
            stencil._backend
            if self.backend == stencil.backend
            else from_name(self.backend)(self.analyzed, dict(stencil.options))
        )
        self.field_infos = self.analyzed.field_infos
        self.parameter_infos = self.analyzed.parameter_infos
        self.written = [
            n for n, i in self.field_infos.items() if i.access & AccessKind.WRITE
        ]
        self.scalar_names = [
            n for n, i in self.parameter_infos.items() if i.access != AccessKind.NONE
        ]
        self._cache: dict[Any, _Layout] = {}
        #: what served each shard in the last call
        self.last_strategy: Optional[list] = None

    def _halo(self, name: str) -> tuple[int, int, int, int]:
        b = self.field_infos[name].boundary
        return (b.lower[0], b.upper[0], b.lower[1], b.upper[1])

    def _axis_plan(self, size: int, n_shards: int, halo_lo: int, halo_hi: int, mode: str):
        """Pad-and-trim plan for one sharded axis: (padded_size, lead, trail).

        Uneven sizes pad to the next mesh multiple; periodic boundaries use
        a cyclic fill with a leading pad >= the low halo so true-edge cells
        still read wrapped values (under clamp/zero the exchange mode itself
        serves the unpadded low edge, so only a trailing pad is needed)."""
        lead = 0
        need = size
        if size % n_shards != 0:
            if mode == "periodic":
                lead = halo_lo
                need = size + halo_lo + halo_hi
        padded = -(-need // n_shards) * n_shards
        local = padded // n_shards
        if max(halo_lo, halo_hi) > local:
            raise ValueError(
                f"Stencil halo width {max(halo_lo, halo_hi)} exceeds the "
                f"per-shard extent {local} (axis size {size} over "
                f"{n_shards} shards) — use a smaller mesh axis or a larger "
                f"domain"
            )
        return padded, lead, padded - size - lead

    # -- a call --------------------------------------------------------------

    def _fields(self, kwargs) -> dict[str, Any]:
        fields = {}
        for name, info in self.field_infos.items():
            if info.access == AccessKind.NONE:
                continue
            if name not in kwargs:
                raise ValueError(f"Missing value for '{name}' field.")
            fields[name] = kwargs[name]
        return fields

    def _layout(self, fields: dict) -> _Layout:
        names = tuple(fields)
        shapes = tuple(tuple(v.shape) for v in fields.values())
        key = (names, shapes)
        layout = self._cache.get(key)
        if layout is None:
            layout = self._cache[key] = _Layout(self, names, shapes)
        return layout

    def prepare(self, **kwargs) -> "Step":
        """Bind one call's arguments to shard buffers (scattering global
        arrays into them) without running it: ``Step.exchange()`` then
        ``Step.compute()`` make the step, ``Step.results()`` its outputs.
        ``apply`` is these four in a row."""
        fields = self._fields(kwargs)
        layout = self._layout(fields)
        scalars = {}
        for name in self.scalar_names:
            if name not in kwargs:
                raise ValueError(f"Missing value for '{name}' parameter.")
            scalars[name] = np.asarray(kwargs[name], dtype=self.parameter_infos[name].dtype)[()]
        buffers = {}
        in_place = {}
        for name, value in fields.items():
            role = layout.roles[name]
            written = name in self.written
            if self._takes(value, role, layout):
                buffers[name] = value.buffers
                in_place[name] = value
                continue
            if written:
                bufs = layout.allocate(role)
            else:
                bufs = layout.read_buffers.get(name)
                if bufs is None:
                    bufs = layout.read_buffers[name] = layout.allocate(role)
            self._fill(value, role, layout, bufs)
            buffers[name] = bufs
        return Step(self, layout, buffers, scalars, fields, in_place)

    def apply(self, **kwargs) -> dict[str, ShardedArray]:
        """Run one distributed stencil step; returns {name: sharded array}
        for written fields. Storage inputs are rebound in place as well."""
        step = self.prepare(**kwargs)
        step.exchange()
        step.compute()
        return step.results()

    def exchange_plan(self, **kwargs) -> list[dict]:
        """The slab transfers one step makes for these fields (the
        counterpart of ``lowered_hlo``: what moves between shards): per
        transfer the field, the phase ("i" or "j"), the kind ("copy" from a
        neighbour, "clamp" or "zero" at a global boundary), the source and
        destination shards and the slab's shape."""
        layout = self._layout(self._fields(kwargs))
        plan = []
        for name, role in layout.roles.items():
            for t in role.transfers:
                plan.append({
                    "field": name, "axis": t.axis, "kind": t.kind, "src": t.src, "dst": t.dst,
                    "slab": t.slab_shape() + role.block[2:],
                })
        return plan

    def _takes(self, value, role: _Role, layout: _Layout) -> bool:
        """Whether ``value`` is a sharded array whose buffers serve ``role``
        as they are."""
        return (
            isinstance(value, ShardedArray)
            and value.buffers is not None
            and not layout.needs_pad
            and value.sharding.mesh is self.mesh
            and value.sharding.spec == role.spec
            and value.halo == role.buffer_halo
            and value.shape == role.shape
            and tuple(value.buffers[0].shape) == role.buffer_shape
            and value.blocks[0].dtype == role.dtype
        )

    def _fill(self, value, role: _Role, layout: _Layout, buffers: list) -> None:
        """Copy ``value`` into the interiors of ``buffers``: block by block
        from a sharded array of the same blocks, else by scattering the
        global array (padded as the layout says)."""
        interior = role.interior
        if (
            isinstance(value, ShardedArray)
            and not layout.needs_pad
            and value.sharding.mesh is self.mesh
            and value.sharding.spec == role.spec
            and tuple(value.blocks[0].shape) == role.block
        ):
            for buf, block in zip(buffers, value.blocks):
                buf[interior].copy_(block)
            return
        if isinstance(value, ShardedArray):
            tensor = value.assemble()
        else:
            tensor = as_tensor(value)
        if tuple(tensor.shape) != role.shape:
            raise ValueError(f"field '{role.name}': shape {tuple(tensor.shape)}, not {role.shape}")
        tensor = self._pad(tensor, role, layout)
        placement = Placement(self.mesh, role.spec)
        for s, buf in enumerate(buffers):
            buf[interior].copy_(tensor[placement.block_index(s, role.block)])

    def _pad(self, tensor: torch.Tensor, role: _Role, layout: _Layout) -> torch.Tensor:
        """The global array extended to the padded extents: a cyclic fill
        under periodic boundaries, the edge under clamp, zeros under zero."""
        for ax, axis in enumerate(role.spec):
            if axis is None:
                continue
            axis_id = 0 if axis == "x" else 1
            _, lead, trail = layout.plans[axis_id]
            if not (lead or trail):
                continue
            n = layout.size_of[axis_id]
            idx = torch.arange(-lead, n + trail, device=tensor.device)
            mode = layout.modes[axis_id]
            idx = idx % n if mode == "periodic" else idx.clamp(0, n - 1)
            tensor = torch.index_select(tensor, ax, idx)
            if mode == "zero":
                tensor.narrow(ax, lead + n, trail).zero_()
        return tensor


class Step:
    """One bound call of a :class:`DistributedStencil` (``prepare``)."""

    def __init__(self, dist, layout: _Layout, buffers, scalars, fields, in_place):
        self.dist = dist
        self.layout = layout
        self.buffers = buffers
        self.scalars = scalars
        self.fields = fields
        self.in_place = in_place

    def exchange(self) -> None:
        """Fill every field's halos from the neighbouring shards."""
        for name, role in self.layout.roles.items():
            if role.transfers:
                halo_exchange.run(role.transfers, self.buffers[name])

    def compute(self) -> None:
        """Run the stencil on every shard's buffers, one shard after the
        other."""
        backend = self.dist._backend
        layout = self.layout
        served = []
        for s in range(len(layout.mesh_devices)):
            arrays = {name: bufs[s] for name, bufs in self.buffers.items()}
            backend.run(arrays, self.scalars, layout.domain, layout.origins)
            served.append(backend.last_strategy)
        self.dist.last_strategy = served

    def sharded(self, name: str) -> ShardedArray:
        """Field ``name`` of this call as a sharded array over its buffers,
        which a later call takes as they are. A read-only field's buffers
        then belong to the array: the stencil's next call fills new ones."""
        if name in self.in_place:
            return self.in_place[name]
        role = self.layout.roles[name]
        bufs = self.buffers[name]
        if self.layout.read_buffers.get(name) is bufs:
            del self.layout.read_buffers[name]
        return ShardedArray(
            [b[role.interior] for b in bufs],
            Placement(self.dist.mesh, role.spec),
            role.shape,
            lead=role.lead,
            buffers=bufs,
            halo=role.buffer_halo,
        )

    def results(self) -> dict[str, ShardedArray]:
        """The written fields as sharded arrays (views of the buffers'
        interiors); Storage arguments are rebound to them."""
        out = {}
        for name in self.dist.written:
            if name not in self.buffers:
                continue
            out[name] = self.sharded(name)
            original = self.fields[name]
            if isinstance(original, Storage):
                original.array = out[name].assemble(original.device)
        return out
