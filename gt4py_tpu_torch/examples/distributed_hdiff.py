"""Multi-device horizontal diffusion: IJ domain decomposition over a device
mesh with a halo exchange (cartesian path), and a field-view Laplacian on a
placed field (field-view path).

Counterpart of examples/distributed_hdiff.py. The mesh is a list of torch
devices, one of which may repeat: the default is the card's four shards,
``[cuda:0] * 4`` (with several cards: one shard each). On ``cuda:hopper``
every shard runs the ``plane`` kernel and the Laplacian, bridged onto the
cartesian kernels, ``fused_plane`` (a 2-D field).

Run: python -m gt4py_tpu_torch.examples.distributed_hdiff [backend]
"""

import sys

import numpy as np
import torch

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.next.common import Dimension, FieldOffset
from gt4py_tpu_torch.parallel import CartesianMesh, DistributedStencil, shard_field

Field3D = gtscript.Field[np.float64]

#: one shard's block, as the JAX example's (32 × 32 per device, 8 levels)
BLOCK = (32, 32, 8)


def hdiff(in_field: Field3D, out_field: Field3D, coeff: Field3D):
    with gtscript.computation("PARALLEL"), gtscript.interval(...):
        lap = 4.0 * in_field[0, 0, 0] - (
            in_field[1, 0, 0] + in_field[-1, 0, 0]
            + in_field[0, 1, 0] + in_field[0, -1, 0]
        )
        flx = lap[1, 0, 0] - lap[0, 0, 0]
        fly = lap[0, 1, 0] - lap[0, 0, 0]
        out_field = in_field[0, 0, 0] - coeff[0, 0, 0] * (
            flx[0, 0, 0] - flx[-1, 0, 0] + fly[0, 0, 0] - fly[0, -1, 0]
        )


I, J = Dimension("I"), Dimension("J")
Ioff = FieldOffset("Ioff", source=I, target=(I,))
Joff = FieldOffset("Joff", source=J, target=(J,))


@gtx.field_operator
def lap(phi):
    return -4.0 * phi + phi(Ioff[1]) + phi(Ioff[-1]) + phi(Joff[1]) + phi(Joff[-1])


def make_stencils(backend: str = "cuda:hopper"):
    """(the hdiff stencil, the Laplacian operator), both for ``backend``."""
    return gtscript.stencil(backend=backend, definition=hdiff), lap.with_backend(backend)


def default_devices() -> list:
    """Four shards on the one card, or one shard on each of several."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("distributed_hdiff runs on the card: pass devices= for the CPU")
    if count == 1:
        return [torch.device("cuda", 0)] * 4
    return [torch.device("cuda", i) for i in range(count)]


def main(backend: str = "cuda:hopper", devices=None, block=BLOCK, stencils=None):
    """Distributed hdiff and the placed Laplacian on data from seed 0 over
    a mesh of ``devices`` (each shard ``block``); returns (hdiff's
    out_field, a sharded array; the Laplacian's out field)."""
    devices = default_devices() if devices is None else list(devices)
    st, op = stencils if stencils is not None else make_stencils(backend)
    mesh = CartesianMesh(devices)
    print(f"mesh: {mesh.shape} over {len(devices)} devices")

    rng = np.random.default_rng(0)
    shape = (block[0] * mesh.nx, block[1] * mesh.ny, block[2])
    dist = DistributedStencil(st, mesh)
    out = dist.apply(
        in_field=rng.random(shape),
        coeff=np.full(shape, 0.05),
        out_field=np.zeros(shape),
    )
    print("cartesian distributed hdiff:", out["out_field"].shape, "done")

    # Field-view path: the placement is recorded, the operator runs whole.
    ni, nj = shape[:2]
    device = mesh.devices[0]
    phi = shard_field(gtx.as_field({I: ni, J: nj}, rng.random((ni, nj)), device=device), mesh)
    # The 5-point laplacian is defined on the interior: ranges (1, n-1).
    out2 = gtx.zeros({I: (1, ni - 1), J: (1, nj - 1)}, device=device)
    op(phi, out=out2, offset_provider={"Ioff": I, "Joff": J})
    print("field-view placed laplacian:", tuple(out2.ndarray.shape), "done")
    return out["out_field"], out2


if __name__ == "__main__":
    main(*sys.argv[1:2])
