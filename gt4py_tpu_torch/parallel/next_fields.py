"""Placements of field-view fields on a mesh.

Counterpart of gt4py_tpu/parallel/next_fields.py. There a field's array is
placed with a ``NamedSharding`` and operators run under ``jax.jit``: GSPMD
partitions the program and inserts the halo collectives. PyTorch has no
partitioner, so the port records the placement and does not split the
computation: :func:`shard_field` returns a Field on the mesh's first device
whose tensor carries its :class:`~gt4py_tpu_torch.parallel.sharded.Placement`
as ``.sharding`` (``shard_shape`` gives one shard's share), and operators
compute on the whole field with the same result. The explicit-ghost path
that does split a field-view computation over shards is
:class:`~gt4py_tpu_torch.parallel.unstructured.DistributedUnstructured`.
"""

from __future__ import annotations

from typing import Optional, Sequence

from gt4py_tpu_torch.next.common import Dimension, DimensionKind
from gt4py_tpu_torch.next.embedded import Field
from gt4py_tpu_torch.parallel.mesh import CartesianMesh
from gt4py_tpu_torch.parallel.sharded import Placement


def field_sharding(
    mesh: CartesianMesh,
    field_dims: Sequence[Dimension],
    dim_map: dict[Dimension, str],
) -> Placement:
    """The placement of a field: ``dim_map`` maps field dimensions to mesh
    axis names ('x'/'y'); unmapped dimensions are whole in every shard."""
    return Placement(mesh, tuple(dim_map.get(d) for d in field_dims))


def _placed(field: Field, placement: Placement) -> Field:
    array = field.ndarray.to(placement.mesh.devices[0])
    if array is field.ndarray:  # tag a view, never the caller's tensor
        array = array.view(array.shape)
    array.sharding = placement
    mask = field.mask.to(array.device) if field.mask is not None else None
    return Field(field.domain, array, mask)


def shard_field(
    field: Field,
    mesh: CartesianMesh,
    dim_map: Optional[dict[Dimension, str]] = None,
) -> Field:
    """The field on the mesh's first device with its placement recorded
    (default: the first two horizontal dimensions onto the mesh's x/y
    axes). Operators applied to it compute on the whole field."""
    if dim_map is None:
        horizontal = [d for d in field.dims if d.kind != DimensionKind.VERTICAL]
        axes = ["x", "y"]
        dim_map = {d: axes[i] for i, d in enumerate(horizontal[: len(axes)])}
    return _placed(field, field_sharding(mesh, field.dims, dim_map))


def constrain_field(field: Field, mesh: CartesianMesh, dim_map: dict[Dimension, str]) -> Field:
    """The counterpart of ``with_sharding_constraint`` on a field inside an
    operator: records the placement, moves nothing between shards."""
    return _placed(field, field_sharding(mesh, field.dims, dim_map))
