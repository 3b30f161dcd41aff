"""The port's own surface of gt4py_tpu_torch.parallel, on the CPU: the
placement and sharded-array types that stand in for a ``NamedSharding``
and a ``jax.Array``, the slab exchange against ``np.pad``, and what
``DistributedStencil`` does with Storages, sharded arrays in written roles
and uneven sharded inputs. Oracles are NumPy."""

import numpy as np
import pytest
import torch

from gt4py_tpu_torch import storage
from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.parallel import (
    CartesianMesh,
    DistributedStencil,
    Placement,
    ShardedArray,
    exchange_halos_2d,
)
from gt4py_tpu_torch.parallel import halo

from tests import torch_stencil_defs as defs

CPU8 = [torch.device("cpu")] * 8


def _mesh(n=8, **kwargs):
    return CartesianMesh([torch.device("cpu")] * n, **kwargs)


def test_placement_shard_shape_and_replication():
    mesh = _mesh()  # (2, 4)
    assert Placement(mesh, ("x", "y", None)).shard_shape((64, 32, 5)) == (32, 8, 5)
    assert Placement(mesh, (None, "y")).shard_shape((6, 32)) == (6, 8)
    assert not Placement(mesh, ("x",)).is_fully_replicated
    assert Placement(mesh, (None, None)).is_fully_replicated
    assert Placement(_mesh(1), ("x", "y")).is_fully_replicated
    with pytest.raises(ValueError, match="mesh axis"):
        Placement(mesh, ("z",))


def test_shard_ij_blocks_are_k_leading_on_their_devices():
    mesh = _mesh()
    x = np.arange(8 * 16 * 3, dtype=np.float64).reshape(8, 16, 3)
    xd = mesh.shard_ij(x)
    assert isinstance(xd, ShardedArray) and xd.shape == x.shape and xd.dtype == np.float64
    assert [b.shape for b in xd.blocks] == [torch.Size([4, 4, 3])] * 8
    for s, block in enumerate(xd.blocks):
        i, j = divmod(s, mesh.ny)
        np.testing.assert_array_equal(block.numpy(), x[4 * i:4 * i + 4, 4 * j:4 * j + 4])
        assert block.stride()[1] == 1 and block.stride()[2] == 16  # J contiguous, K leading
    np.testing.assert_array_equal(np.asarray(xd), x)
    with pytest.raises(ValueError, match="evenly"):
        mesh.shard_ij(np.zeros((7, 16, 3)))


@pytest.mark.parametrize("boundary,mode", [("periodic", "wrap"), ("clamp", "edge"),
                                           ("zero", "constant")])
@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 8), (8, 1)])
def test_exchange_matches_np_pad(boundary, mode, mesh_shape):
    """Every shard's extended block equals the matching window of the
    global array padded as the boundary condition says (corners too)."""
    mesh = _mesh(shape=mesh_shape)
    rng = np.random.default_rng(4)
    bi, bj = 4, 3
    g = rng.random((bi * mesh.nx, bj * mesh.ny, 2))
    widths = (2, 1, 1, 2)
    ext = exchange_halos_2d(mesh.shard_ij(g).blocks, mesh, widths, boundary=boundary)
    padded = np.pad(g, ((2, 1), (1, 2), (0, 0)), mode=mode)
    for s, e in enumerate(ext):
        i, j = divmod(s, mesh.ny)
        np.testing.assert_array_equal(
            e.numpy(), padded[i * bi:i * bi + bi + 3, j * bj:j * bj + bj + 3])


def test_mixed_boundary_and_plan_order():
    mesh = _mesh()
    plan = halo.plan(mesh, (4, 4), (1, 1, 1, 1), boundary=("clamp", "periodic"))
    assert [t.axis for t in plan] == ["i"] * 16 + ["j"] * 16  # I slabs first
    kinds = {(t.axis, t.kind) for t in plan}
    assert kinds == {("i", "copy"), ("i", "clamp"), ("j", "copy")}
    with pytest.raises(ValueError, match="boundary mode"):
        halo.plan(mesh, (4, 4), (1, 1, 1, 1), boundary="reflect")
    with pytest.raises(ValueError, match="exceeds"):
        halo.plan(mesh, (4, 4), (2, 0, 0, 0), buffer_halo=(1, 0, 0, 0))


def _hdiff(backend="torch"):
    return gtscript.stencil(backend=backend, definition=defs.horizontal_diffusion)


def test_storage_arguments_are_rebound():
    """A written Storage takes the result, as the JAX package's setter
    rebinds it; the read ones keep their values."""
    mesh = _mesh()
    shape = (16, 16, 3)
    rng = np.random.default_rng(2)
    a, c = rng.random(shape), rng.random(shape)
    fields = {n: storage.from_array(v, backend="numpy") for n, v in
              (("in_field", a), ("coeff", c), ("out_field", np.zeros(shape)))}
    out = DistributedStencil(_hdiff(), mesh).apply(**fields)
    np.testing.assert_array_equal(fields["out_field"].asnumpy(), np.asarray(out["out_field"]))
    np.testing.assert_array_equal(fields["in_field"].asnumpy(), a)
    assert np.abs(fields["out_field"].asnumpy()).sum() > 0


def test_written_sharded_array_is_written_in_place():
    """A sharded array of the layout in a written role takes the result in
    its own buffers, and a ping-pong of two arrays equals a Python loop of
    global calls."""
    mesh = _mesh()
    shape = (16, 16, 3)
    rng = np.random.default_rng(3)
    a, c = rng.random(shape), 0.1 * rng.random(shape)
    dist = DistributedStencil(_hdiff(), mesh)
    step = dist.prepare(in_field=a, coeff=c, out_field=np.zeros(shape))
    arrays = {n: step.sharded(n) for n in ("in_field", "coeff", "out_field")}
    cur, nxt = arrays["in_field"], arrays["out_field"]
    for _ in range(3):
        res = dist.apply(in_field=cur, coeff=arrays["coeff"], out_field=nxt)
        assert res["out_field"] is nxt
        cur, nxt = nxt, cur
    want = a
    for _ in range(3):
        step = dist.apply(in_field=want, coeff=c, out_field=np.zeros(shape))
        want = np.asarray(step["out_field"])
    np.testing.assert_allclose(np.asarray(cur), want, rtol=1e-12)


def test_uneven_sharded_input_is_padded_again():
    """An uneven result's pad cells hold no data: fed back, it is gathered
    and padded again, and two steps equal two global ones."""
    mesh = _mesh()
    shape = (13, 21, 2)
    rng = np.random.default_rng(5)
    a, c = rng.random(shape), 0.1 * rng.random(shape)
    dist = DistributedStencil(_hdiff(), mesh)
    first = dist.apply(in_field=a, coeff=c, out_field=np.zeros(shape))["out_field"]
    assert first.shape == shape and any(first.lead)
    second = dist.apply(in_field=first, coeff=c, out_field=np.zeros(shape))["out_field"]
    want = dist.apply(in_field=np.asarray(first), coeff=c, out_field=np.zeros(shape))
    np.testing.assert_array_equal(np.asarray(second), np.asarray(want["out_field"]))


def test_missing_arguments_raise():
    dist = DistributedStencil(_hdiff(), _mesh())
    with pytest.raises(ValueError, match="Missing value for 'coeff'"):
        dist.apply(in_field=np.zeros((8, 8, 2)), out_field=np.zeros((8, 8, 2)))
    vadv = gtscript.stencil(backend="torch", definition=defs.vertical_advection_dycore,
                            externals=defs.VADV_EXTERNALS)
    shape = (8, 8, 4)
    with pytest.raises(ValueError, match="Missing value for 'dtr_stage'"):
        DistributedStencil(vadv, _mesh()).apply(
            **{n: np.zeros(shape) for n in ("utens_stage", "u_stage", "wcon", "u_pos", "utens")})


def test_backend_defaults_and_override():
    """cuda:hopper stencils shard onto cuda:hopper, others onto torch; any
    registered backend can be asked for."""
    hop = _hdiff("cuda:hopper")
    assert DistributedStencil(hop, _mesh()).backend == "cuda:hopper"
    assert DistributedStencil(_hdiff("numpy"), _mesh()).backend == "torch"
    dist = DistributedStencil(hop, _mesh(), backend="torch")
    assert dist._backend.name == "torch" and dist._backend is not hop._backend
    shape = (16, 16, 2)
    rng = np.random.default_rng(6)
    args = dict(in_field=rng.random(shape), coeff=rng.random(shape), out_field=np.zeros(shape))
    np.testing.assert_array_equal(np.asarray(dist.apply(**args)["out_field"]),
                                  np.asarray(DistributedStencil(hop, _mesh()).apply(**args)[
                                      "out_field"]))
    assert dist.last_strategy == ["plain"] * 8


def test_ring_failing_shard_raises_and_leaves_no_thread():
    """An operator that fails on one shard of DistributedUnstructured
    raises its error and leaves no shard's thread waiting; the next call
    runs as before."""
    import threading

    import gt4py_tpu_torch.next as gtx
    from gt4py_tpu_torch.next import Dimension, DimensionKind, FieldOffset, neighbor_sum
    from gt4py_tpu_torch.parallel import DistributedUnstructured

    V = Dimension("Vertex")
    VDim = Dimension("V2V", kind=DimensionKind.LOCAL)
    V2V = FieldOffset("V2V", source=V, target=(V, VDim))
    calls = []

    def ring_sum(f):
        calls.append(1)
        if len(calls) == 6:  # the second call's second shard
            raise ArithmeticError("shard fails")
        return neighbor_sum(f(V2V), axis=VDim)

    n = 32
    conn = gtx.as_connectivity([V, VDim], V, (np.arange(n)[:, None] + [[-1, 0, 1]]) % n,
                               device="cpu")
    x = gtx.as_field([V], np.arange(n, dtype=np.float64), device="cpu")
    dist = DistributedUnstructured(ring_sum, offset_provider={"V2V": conn}, sizes={V: n},
                                   mesh=[torch.device("cpu")] * 4)
    want = x.asnumpy()[(np.arange(n)[:, None] + [-1, 0, 1]) % n].sum(axis=1)
    np.testing.assert_array_equal(dist(x).asnumpy(), want)
    with pytest.raises(ArithmeticError, match="shard fails"):
        dist(x)
    assert not [t for t in threading.enumerate() if t.name.startswith("gt4py-shard")]
    np.testing.assert_array_equal(dist(x).asnumpy(), want)


# --- on the card ------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("cards", [1, 2, 4])
@pytest.mark.parametrize("name, boundary", [("horizontal_diffusion", "periodic"),
                                            ("horizontal_diffusion", "clamp"),
                                            ("vertical_advection_dycore", "periodic"),
                                            ("tridiagonal_solver", "zero")])
def test_mesh_of_cards_equals_one_card_to_the_bit(cards, name, boundary):
    """A 2 × 2 mesh whose four shards lie on ``cards`` cards (one card:
    ``[cuda:0] * 4``; two: alternating; four: one each) runs the stencil's
    kernel on every shard and equals the single-card stencil on the
    boundary-extended storage to the bit: the exchange's copies between
    cards are ordered with each card's kernels."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA card(s) and nvcc")
    entry = defs.REGISTRY[name]
    st = gtscript.stencil(backend="cuda:hopper", definition=entry["definition"],
                          externals=entry["externals"], dtypes=entry["dtypes"])
    mesh = CartesianMesh([torch.device("cuda", p % cards) for p in range(4)])
    assert mesh.shape == (2, 2)
    shape, halo = (32, 24, 8), 2
    host = defs.make_inputs(st.field_info, shape, np.random.default_rng(cards))
    dist = DistributedStencil(st, mesh, boundary=boundary)
    out = dist.apply(**host, **entry["scalars"])
    assert dist.last_strategy == [entry["strategy"]] * 4
    mode = {"periodic": "wrap", "clamp": "edge", "zero": "constant"}[boundary]
    single = {n: storage.from_array(np.pad(v, ((halo, halo), (halo, halo), (0, 0)), mode=mode),
                                    backend="cuda:hopper", aligned_index=(halo, halo, 0),
                                    device="cuda")
              for n, v in host.items()}
    st(**single, **entry["scalars"], domain=shape)
    assert out
    for n, got in out.items():
        want = np.asarray(single[n])[halo:halo + shape[0], halo:halo + shape[1]]
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=n)
