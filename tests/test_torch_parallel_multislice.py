"""tests/parallel_tests/test_multislice.py on the port: slice-aware mesh
placement over eight CPU devices with synthesized ``slice_indices``.

Torch devices carry no slice index, so every multi-slice layout comes from
``slice_indices=``, as on the JAX package's virtual mesh. The devices are
eight distinct ``torch.device("cpu")`` objects, so the tests can tell them
apart by identity."""

import numpy as np
import pytest
import torch

from gt4py_tpu_torch.parallel import CartesianMesh
from gt4py_tpu_torch.parallel.mesh import _factor2


def _devs():
    return [torch.device("cpu") for _ in range(8)]


def test_single_slice_flat_layout():
    mesh = CartesianMesh(_devs())
    assert mesh.n_slices == 1
    assert mesh.dcn_boundaries() == []
    assert mesh.nx * mesh.ny == 8
    assert mesh.is_intra_slice("x", 0) and mesh.is_intra_slice("y", 0)


def test_two_slices_grouped_along_x():
    devs = _devs()
    # devices interleaved across slices on purpose: placement must regroup
    slices = [0, 1, 0, 1, 0, 1, 0, 1]
    mesh = CartesianMesh(devs, slice_indices=slices)
    assert mesh.n_slices == 2
    # 4 devices per slice -> per-slice block (2, 2); global (4, 2)
    assert mesh.shape == (4, 2)
    by_dev_slice = {id(d): s for d, s in zip(devs, slices)}
    grid = mesh.device_grid
    for x in range(mesh.nx):
        for y in range(mesh.ny):
            assert by_dev_slice[id(grid[x, y])] == mesh.slice_of(x, y)
    # slice 0 owns x rows 0-1, slice 1 owns 2-3
    assert [mesh.slice_of(x, 0) for x in range(4)] == [0, 0, 1, 1]
    # the only slice crossings along x: row 1->2 and the periodic wrap 3->0
    assert mesh.dcn_boundaries() == [1, 3]
    assert mesh.is_intra_slice("x", 0)
    assert not mesh.is_intra_slice("x", 1)
    assert mesh.is_intra_slice("x", 2)
    assert not mesh.is_intra_slice("x", 3)
    # y exchanges never cross slices
    assert all(mesh.is_intra_slice("y", i) for i in range(mesh.ny))


def test_four_slices():
    mesh = CartesianMesh(_devs(), slice_indices=[0, 0, 1, 1, 2, 2, 3, 3])
    assert mesh.n_slices == 4
    assert mesh.shape == (4, 2)  # each slice one x row of 2
    assert [mesh.slice_of(x, 0) for x in range(4)] == [0, 1, 2, 3]
    assert mesh.dcn_boundaries() == [0, 1, 2, 3]


def test_explicit_shape_multi_slice():
    devs = _devs()
    mesh = CartesianMesh(devs, shape=(2, 4), slice_indices=[0] * 4 + [1] * 4)
    assert mesh.shape == (2, 4)
    assert [mesh.slice_of(x, 0) for x in range(2)] == [0, 1]
    with pytest.raises(ValueError):
        CartesianMesh(devs, shape=(3, 3), slice_indices=[0] * 8)


def test_irregular_slices_fall_back():
    mesh = CartesianMesh(_devs(), slice_indices=[0, 0, 0, 1, 1, 1, 1, 1])
    # unequal slice sizes: graceful flat fallback, still a working mesh
    assert mesh.nx * mesh.ny == 8
    assert mesh.dcn_boundaries() == []


def test_sharded_compute_on_multislice_mesh():
    """End-to-end: an IJ-sharded array computes correctly on the
    slice-grouped mesh (placement changes layout, not semantics)."""
    mesh = CartesianMesh(_devs(), slice_indices=[0, 1, 0, 1, 0, 1, 0, 1])
    x = np.arange(8 * 8 * 4, dtype=np.float32).reshape(8, 8, 4)
    xd = mesh.shard_ij(x)
    y = xd.map_blocks(lambda a: a * 2.0 + 1.0)
    assert y.sharding == xd.sharding and not y.is_fully_replicated
    np.testing.assert_allclose(np.asarray(y), x * 2.0 + 1.0)


def test_factor2():
    assert _factor2(8) == (2, 4)
    assert _factor2(4) == (2, 2)
    assert _factor2(7) == (1, 7)
