"""tests/parallel_tests/test_distributed.py on the port: DistributedStencil
on a mesh of eight CPU devices (``[torch.device("cpu")] * 8``, the port's
counterpart of the JAX package's eight virtual CPU devices) must match the
periodic, clamp and zero oracles. The HLO assertion becomes one on
``exchange_plan``: only neighbour slabs move, and no shard receives a whole
field. Each test keeps its reference's name."""

import numpy as np
import pytest
import torch

from gt4py_tpu_torch.cartesian import gtscript
from gt4py_tpu_torch.parallel import CartesianMesh, DistributedStencil

from tests import torch_stencil_defs as defs

CPU8 = [torch.device("cpu")] * 8


def _mesh(**kwargs):
    return CartesianMesh(CPU8, **kwargs)


def _periodic_hdiff_oracle(in_field, coeff):
    """hdiff on a periodic domain via np.roll (the halo wrap)."""

    def roll(a, di, dj):
        return np.roll(np.roll(a, -di, axis=0), -dj, axis=1)

    lap = 4.0 * in_field - (
        roll(in_field, 1, 0) + roll(in_field, -1, 0) + roll(in_field, 0, 1) + roll(in_field, 0, -1)
    )
    res1 = roll(lap, 1, 0) - lap
    flx = np.where(res1 * (roll(in_field, 1, 0) - in_field) > 0, 0.0, res1)
    res2 = roll(lap, 0, 1) - lap
    fly = np.where(res2 * (roll(in_field, 0, 1) - in_field) > 0, 0.0, res2)
    return in_field - coeff * (flx - roll(flx, -1, 0) + fly - roll(fly, 0, -1))


def test_distributed_hdiff_matches_periodic_oracle():
    mesh = _mesh()
    st = gtscript.stencil(backend="torch", definition=defs.horizontal_diffusion)
    dist = DistributedStencil(st, mesh)

    rng = np.random.default_rng(7)
    shape = (32, 16, 4)
    in_field = rng.random(shape)
    coeff = rng.random(shape)
    out = dist.apply(in_field=in_field, coeff=coeff, out_field=np.zeros(shape))
    expected = _periodic_hdiff_oracle(in_field, coeff)
    np.testing.assert_allclose(np.asarray(out["out_field"]), expected, rtol=1e-12)


def test_distributed_tridiagonal_matches_single_chip():
    mesh = _mesh()
    st = gtscript.stencil(backend="torch", definition=defs.tridiagonal_solver)
    dist = DistributedStencil(st, mesh)

    rng = np.random.default_rng(3)
    shape = (16, 16, 8)
    inf = -np.ones(shape)
    diag = np.full(shape, 4.0)
    sup = -np.ones(shape)
    rhs = rng.random(shape)
    expected = defs.validate_tridiagonal_solver(inf, diag, sup, rhs)
    out = dist.apply(
        inf=inf.copy(), diag=diag.copy(), sup=sup.copy(), rhs=rhs.copy(), out=np.zeros(shape)
    )
    np.testing.assert_allclose(np.asarray(out["out"]), expected, rtol=1e-12)


def test_halo_exchange_roundtrip():
    """The slab exchange reproduces np.pad(mode='wrap')-padded blocks."""
    from gt4py_tpu_torch.parallel.halo import exchange_halos_2d

    mesh = _mesh()
    rng = np.random.default_rng(0)
    global_arr = rng.random((8 * mesh.nx, 8 * mesh.ny, 2))
    blocks = mesh.shard_ij(global_arr).blocks
    ext = exchange_halos_2d(blocks, mesh, (2, 1, 1, 2))
    # Shard (0, 0)'s extended block, reconstructed with periodic wrap:
    blk = ext[0].numpy()
    wrapped = np.pad(global_arr, ((2, 1), (1, 2), (0, 0)), mode="wrap")
    np.testing.assert_allclose(blk, wrapped[: 8 + 3, : 8 + 3])


def _clamped_hdiff_oracle(in_field, coeff):
    """hdiff with clamp (edge-replication) boundaries: pad the INPUT by the
    full halo (2) with edge mode and run the plain halo'd formula."""
    p = np.pad(in_field, ((2, 2), (2, 2), (0, 0)), mode="edge")
    c = np.pad(coeff, ((2, 2), (2, 2), (0, 0)), mode="edge")
    return defs.validate_horizontal_diffusion(p, c)


def test_distributed_clamp_boundary():
    """Non-periodic (edge-replicated) global boundaries: must match the
    np.pad(mode='edge') oracle, NOT the torus."""
    mesh = _mesh()
    st = gtscript.stencil(backend="torch", definition=defs.horizontal_diffusion)
    dist = DistributedStencil(st, mesh, boundary="clamp")

    rng = np.random.default_rng(11)
    shape = (32, 16, 3)
    in_field = rng.random(shape)
    coeff = rng.random(shape)
    out = dist.apply(in_field=in_field, coeff=coeff, out_field=np.zeros(shape))
    expected = _clamped_hdiff_oracle(in_field, coeff)
    np.testing.assert_allclose(np.asarray(out["out_field"]), expected, rtol=1e-12)
    periodic = _periodic_hdiff_oracle(in_field, coeff)
    assert not np.allclose(np.asarray(out["out_field"]), periodic)


def test_distributed_zero_boundary_smooth():
    """Zero-filled halos: a 4-point average with zero boundaries."""

    from gt4py_tpu_torch.cartesian.gtscript import PARALLEL, computation, interval

    def smooth(inp: defs.Field3D, out: defs.Field3D):
        with computation(PARALLEL), interval(...):
            out = 0.25 * (inp[1, 0, 0] + inp[-1, 0, 0] + inp[0, 1, 0] + inp[0, -1, 0])

    mesh = _mesh()
    st = gtscript.stencil(backend="torch", definition=smooth)
    dist = DistributedStencil(st, mesh, boundary="zero")
    rng = np.random.default_rng(13)
    shape = (16, 16, 2)
    inp = rng.random(shape)
    out = dist.apply(inp=inp, out=np.zeros(shape))
    p = np.pad(inp, ((1, 1), (1, 1), (0, 0)))
    expected = 0.25 * (p[2:, 1:-1] + p[:-2, 1:-1] + p[1:-1, 2:] + p[1:-1, :-2])
    np.testing.assert_allclose(np.asarray(out["out"]), expected, rtol=1e-12)


def test_distributed_vadv_interval_sections():
    """The vadv dycore class (multi-section FORWARD/BACKWARD loops with
    K-offset reads) over the mesh."""
    mesh = _mesh()
    st = gtscript.stencil(
        backend="torch",
        definition=defs.vertical_advection_dycore,
        externals=defs.VADV_EXTERNALS,
    )
    dist = DistributedStencil(st, mesh)
    rng = np.random.default_rng(5)
    shape = (16, 8, 9)
    utens_stage = rng.random(shape)
    u_stage = rng.random(shape)
    wcon = rng.random(shape)
    u_pos = rng.random(shape)
    utens = rng.random(shape)
    expected = defs.validate_vertical_advection_dycore(
        utens_stage, u_stage, wcon, u_pos, utens, 0.15
    )
    out = dist.apply(
        utens_stage=utens_stage.copy(), u_stage=u_stage, wcon=wcon,
        u_pos=u_pos, utens=utens, dtr_stage=0.15,
    )
    result = np.asarray(out["utens_stage"])
    # interior I rows (the last global row reads wrapped wcon)
    np.testing.assert_allclose(result[: shape[0] - 1], expected, rtol=1e-10)


def test_distributed_pallas_backend_in_shards():
    """The kernel backend serves inside the shards: on CPU tensors each
    shard runs the kernels' plain version, and says so."""
    mesh = _mesh()
    st = gtscript.stencil(backend="cuda:hopper", definition=defs.horizontal_diffusion)
    dist = DistributedStencil(st, mesh, backend="cuda:hopper")
    assert dist._backend is st._backend and st._backend.strategy == "plane"
    rng = np.random.default_rng(17)
    shape = (32, 16, 4)
    in_field = rng.random(shape)
    coeff = rng.random(shape)
    out = dist.apply(in_field=in_field, coeff=coeff, out_field=np.zeros(shape))
    expected = _periodic_hdiff_oracle(in_field, coeff)
    np.testing.assert_allclose(np.asarray(out["out_field"]), expected, rtol=1e-12)
    assert dist.last_strategy == ["plain"] * 8


# --- uneven domain decomposition (pad-and-trim) ------------------------------


def test_uneven_periodic_matches_oracle():
    """NI/NJ not divisible by the mesh: cyclic pad + trim must reproduce
    the periodic oracle exactly."""
    mesh = _mesh()
    st = gtscript.stencil(backend="torch", definition=defs.horizontal_diffusion)
    dist = DistributedStencil(st, mesh)

    rng = np.random.default_rng(11)
    shape = (30, 17, 3)
    in_field = rng.random(shape)
    coeff = rng.random(shape)
    out = dist.apply(in_field=in_field, coeff=coeff, out_field=np.zeros(shape))
    expected = _periodic_hdiff_oracle(in_field, coeff)
    np.testing.assert_allclose(np.asarray(out["out_field"]), expected, rtol=1e-12)
    assert out["out_field"].shape == shape


def test_uneven_clamp_matches_single_chip():
    mesh = _mesh()
    st = gtscript.stencil(backend="torch", definition=defs.lap_of_lap)
    dist = DistributedStencil(st, mesh, boundary="clamp")

    rng = np.random.default_rng(12)
    shape = (19, 13, 2)
    inp = rng.random(shape)

    halo = 2
    padded = np.pad(inp, ((halo, halo), (halo, halo), (0, 0)), mode="edge")
    st_np = gtscript.stencil(backend="numpy", definition=defs.lap_of_lap)
    out_np = np.zeros_like(padded)
    st_np(padded, out_np, origin=(halo, halo, 0), domain=shape)
    expected = out_np[halo:-halo, halo:-halo]

    out = dist.apply(inp=inp, out=np.zeros(shape))
    np.testing.assert_allclose(np.asarray(out["out"]), expected, rtol=1e-12)


def test_uneven_zero_boundary():
    mesh = _mesh()
    st = gtscript.stencil(backend="torch", definition=defs.shift_all_directions)
    dist = DistributedStencil(st, mesh, boundary="zero")

    rng = np.random.default_rng(13)
    shape = (9, 11, 2)
    inp = rng.random(shape)
    halo = 1
    padded = np.pad(inp, ((halo, halo), (halo, halo), (0, 0)))
    st_np = gtscript.stencil(backend="numpy", definition=defs.shift_all_directions)
    out_np = np.zeros_like(padded)
    st_np(padded, out_np, origin=(halo, halo, 0), domain=shape)
    expected = out_np[halo:-halo, halo:-halo]

    out = dist.apply(inp=inp, out=np.zeros(shape))
    np.testing.assert_allclose(np.asarray(out["out"]), expected, rtol=1e-12)


def test_odd_mesh_shape_uneven():
    """Explicit (1, 8) mesh: every shard gets a ragged share of a
    prime-sized axis."""
    mesh = _mesh(shape=(1, 8))
    st = gtscript.stencil(backend="torch", definition=defs.horizontal_diffusion)
    dist = DistributedStencil(st, mesh)

    rng = np.random.default_rng(14)
    shape = (13, 29, 2)
    in_field = rng.random(shape)
    coeff = rng.random(shape)
    out = dist.apply(in_field=in_field, coeff=coeff, out_field=np.zeros(shape))
    expected = _periodic_hdiff_oracle(in_field, coeff)
    np.testing.assert_allclose(np.asarray(out["out_field"]), expected, rtol=1e-12)


def test_halo_exceeds_shard_width_raises():
    n = 8
    mesh = _mesh(shape=(1, n))
    st = gtscript.stencil(backend="torch", definition=defs.horizontal_diffusion)
    dist = DistributedStencil(st, mesh)
    shape = (8, n * 2, 2)  # shard J width 2 == halo 2: ok; width 1 raises
    rng = np.random.default_rng(15)
    ok = dist.apply(
        in_field=rng.random(shape),
        coeff=rng.random(shape),
        out_field=np.zeros(shape),
    )
    assert ok["out_field"].shape == shape
    bad = (8, n, 2)
    with pytest.raises(ValueError, match="halo width"):
        dist.apply(
            in_field=rng.random(bad),
            coeff=rng.random(bad),
            out_field=np.zeros(bad),
        )


def test_hlo_collective_permute_no_allgather():
    """The sharded hdiff step moves halos as neighbour slabs and never
    hands a shard a whole field (the HLO's collective-permute and no
    all-gather)."""
    mesh = _mesh()
    st = gtscript.stencil(backend="torch", definition=defs.horizontal_diffusion)
    dist = DistributedStencil(st, mesh)
    shape = (8 * mesh.nx, 8 * mesh.ny, 3)
    rng = np.random.default_rng(0)
    plan = dist.exchange_plan(
        in_field=rng.random(shape),
        coeff=rng.random(shape),
        out_field=np.zeros(shape),
    )
    assert plan and {t["kind"] for t in plan} == {"copy"}
    assert {t["field"] for t in plan} == {"in_field"}  # the only field read at offsets
    for t in plan:
        x, y = divmod(t["dst"], mesh.ny)
        sx, sy = divmod(t["src"], mesh.ny)
        assert (t["axis"], sy) == ("i", y) or (t["axis"], sx) == ("j", x)
        assert ((sx - x) % mesh.nx in (1, mesh.nx - 1)) or ((sy - y) % mesh.ny in (1, mesh.ny - 1))
        # a slab 2 cells deep along its axis, never a block
        assert t["slab"][0 if t["axis"] == "i" else 1] == 2
    # four slabs a shard (lo and hi along I and J)
    assert len(plan) == 4 * 8
    for shard in range(8):
        received = sum(np.prod(t["slab"]) for t in plan if t["dst"] == shard)
        assert received < np.prod(shape) / 4  # far from a whole field


def test_multi_step_chain_stays_sharded():
    """Feeding one step's sharded output into the next keeps every
    intermediate sharded over the mesh — no per-step host transfer or
    silent replication: the next step takes the result's buffers as they
    are."""
    mesh = _mesh()
    st = gtscript.stencil(backend="torch", definition=defs.horizontal_diffusion)
    dist = DistributedStencil(st, mesh)
    shape = (8 * mesh.nx, 8 * mesh.ny, 3)
    rng = np.random.default_rng(1)
    out = dist.apply(
        in_field=rng.random(shape),
        coeff=rng.random(shape),
        out_field=np.zeros(shape),
    )
    coeff_d = out["out_field"]
    cur = out["out_field"]
    for _ in range(4):
        step = dist.prepare(in_field=cur, coeff=coeff_d, out_field=np.zeros(shape))
        assert step.buffers["in_field"] is cur.buffers  # no gather, no scatter
        step.exchange()
        step.compute()
        cur = step.results()["out_field"]
        assert hasattr(cur, "sharding") and not cur.sharding.is_fully_replicated
    assert np.isfinite(np.asarray(cur)).all()
