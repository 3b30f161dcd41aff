"""Multi-device execution of the port over a mesh of torch devices.

Counterpart of gt4py_tpu/parallel/ (same exports, plus the sharded-array
types the JAX package gets from ``jax.Array``): one controlling process
drives every shard of a :class:`CartesianMesh` of ``torch.device``s, and a
device may repeat (``[torch.device("cuda", 0)] * 4`` runs four shards on
one card).
"""

from gt4py_tpu_torch.parallel.mesh import CartesianMesh  # noqa: F401
from gt4py_tpu_torch.parallel.distributed import DistributedStencil  # noqa: F401
from gt4py_tpu_torch.parallel.halo import exchange_halos_2d  # noqa: F401
from gt4py_tpu_torch.parallel.next_fields import (  # noqa: F401
    constrain_field,
    field_sharding,
    shard_field,
)
from gt4py_tpu_torch.parallel.sharded import Placement, ShardedArray  # noqa: F401
from gt4py_tpu_torch.parallel.unstructured import (  # noqa: F401
    DistributedUnstructured,
    ShardedGather,
    halo_gather,
    partition_gather,
    ring_partition,
)
