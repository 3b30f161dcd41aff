"""tests/parallel_tests/test_next_distributed.py on the port: field-view
fields placed on a mesh of eight CPU devices.

PyTorch has no partitioner: ``shard_field`` records the placement (the
tensor's ``.sharding``) and operators compute on the whole field, so each
test holds the placed run against the single-device run, as the reference
does; the ``jax.jit`` wrappers become plain calls."""

import numpy as np
import pytest
import torch

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.next.common import Dimension, DimensionKind, FieldOffset
from gt4py_tpu_torch.next.field_utils import asnumpy
from gt4py_tpu_torch.parallel import CartesianMesh, shard_field

I = Dimension("I")
J = Dimension("J")
K = Dimension("K", kind=DimensionKind.VERTICAL)
Ioff = FieldOffset("Ioff", source=I, target=(I,))
Joff = FieldOffset("Joff", source=J, target=(J,))

CPU = "cpu"


@pytest.fixture
def mesh():
    return CartesianMesh([torch.device("cpu")] * 8)


def test_sharded_laplacian_matches_single_device(mesh):
    rng = np.random.default_rng(0)
    data = rng.random((64, 64, 4))
    phi = gtx.as_field({I: 64, J: 64, K: 4}, data, device=CPU)
    phi_sharded = shard_field(phi, mesh)

    @gtx.field_operator
    def lap(phi):
        return (
            -4.0 * phi
            + phi(Ioff[1]) + phi(Ioff[-1])
            + phi(Joff[1]) + phi(Joff[-1])
        )

    op = {"Ioff": I, "Joff": J}
    out_ref = gtx.zeros({I: (1, 63), J: (1, 63), K: 4}, device=CPU)
    lap(phi, out=out_ref, offset_provider=op)
    assert asnumpy(out_ref).shape == (62, 62, 4)
    expected = (
        -4.0 * data[1:-1, 1:-1]
        + data[2:, 1:-1] + data[:-2, 1:-1]
        + data[1:-1, 2:] + data[1:-1, :-2]
    )
    np.testing.assert_allclose(asnumpy(out_ref), expected, rtol=1e-12)

    out_sh = gtx.zeros({I: (1, 63), J: (1, 63), K: 4}, device=CPU)
    lap(phi_sharded, out=out_sh, offset_provider=op)
    np.testing.assert_allclose(asnumpy(out_sh), expected, rtol=1e-12)


def test_sharding_placement(mesh):
    phi = gtx.as_field({I: 64, J: 64}, np.zeros((64, 64)), device=CPU)
    sh = shard_field(phi, mesh)
    sharding = sh.ndarray.sharding
    # I split over x (2), J over y (4): per-device shard is (32, 16)
    assert sharding.shard_shape((64, 64)) == (64 // mesh.nx, 64 // mesh.ny)
    assert sharding.spec == ("x", "y") and not sharding.is_fully_replicated
    assert not hasattr(phi.ndarray, "sharding")  # the caller's tensor is untouched


def test_sharded_scan(mesh):
    rng = np.random.default_rng(1)
    data = rng.random((16, 16, 8))
    inp = shard_field(gtx.as_field({I: 16, J: 16, K: 8}, data, device=CPU), mesh)

    @gtx.scan_operator(axis=K, forward=True, init=0.0)
    def cumsum(carry: float, x: float) -> float:
        return carry + x

    out = gtx.zeros({I: 16, J: 16, K: 8}, device=CPU)
    cumsum(inp, out=out)
    np.testing.assert_allclose(asnumpy(out), np.cumsum(data, axis=2), rtol=1e-12)


def test_sharded_unstructured_nabla(mesh):
    """Unstructured gathers + neighbour reductions on placed vertex fields:
    the result matches single-device."""
    from gt4py_tpu_torch.next import neighbor_sum
    from gt4py_tpu_torch.next.embedded import offset_provider_context
    from gt4py_tpu_torch.parallel.next_fields import field_sharding
    from tests.test_torch_field_ops import make_periodic_mesh

    V = Dimension("Vertex")
    E = Dimension("Edge")
    V2EDim = Dimension("V2E", kind=DimensionKind.LOCAL)
    E2VDim = Dimension("E2V", kind=DimensionKind.LOCAL)
    E2V = FieldOffset("E2V", source=V, target=(E, E2VDim))
    V2E = FieldOffset("V2E", source=E, target=(V, V2EDim))

    n = 16
    e2v_np, v2e_np, signs_np = make_periodic_mesh(n)
    nv = n * n
    rng = np.random.default_rng(4)
    pp_np = rng.random(nv)
    sx_np = rng.random(2 * nv)
    vol_np = rng.random(nv) + 0.5

    e2v = gtx.as_connectivity([E, E2VDim], V, e2v_np, device=CPU)
    v2e = gtx.as_connectivity([V, V2EDim], E, v2e_np, device=CPU)
    prov = {"E2V": e2v, "V2E": v2e}
    sign_f = gtx.as_field([V, V2EDim], signs_np, device=CPU)

    @gtx.field_operator
    def nabla_x(pp, s_x, sign, vol):
        zavg = 0.5 * (pp(E2V[0]) + pp(E2V[1])) * s_x
        return neighbor_sum(zavg(V2E) * sign, axis=V2EDim) / vol

    ref = gtx.zeros({V: nv}, device=CPU)
    nabla_x(
        gtx.as_field([V], pp_np, device=CPU), gtx.as_field([E], sx_np, device=CPU), sign_f,
        gtx.as_field([V], vol_np, device=CPU), out=ref, offset_provider=prov,
    )

    sharding = field_sharding(mesh, (V,), {V: "x"})
    pp_t = torch.as_tensor(pp_np)
    pp_t.sharding = sharding
    vol_t = torch.as_tensor(vol_np)
    vol_t.sharding = sharding
    pp_sh = gtx.Field(gtx.domain({V: nv}), pp_t)
    vol_sh = gtx.Field(gtx.domain({V: nv}), vol_t)

    def step(pp, sx, vol):
        with offset_provider_context(prov):
            return nabla_x.definition(pp, gtx.as_field([E], sx, device=CPU), sign_f, vol).ndarray

    out = step(pp_sh, sx_np, vol_sh)
    np.testing.assert_allclose(out.numpy(), ref.asnumpy(), rtol=1e-12)


def test_sharded_whole_program(mesh):
    """A @gtx.program pipeline over placed fields matches single-device
    results."""
    rng = np.random.default_rng(9)
    data = rng.random((32, 32))

    @gtx.field_operator
    def lap(phi):
        return -4.0 * phi + phi(Ioff[1]) + phi(Ioff[-1]) + phi(Joff[1]) + phi(Joff[-1])

    @gtx.field_operator
    def relax(phi, l):
        return phi + 0.1 * l

    @gtx.program
    def smooth(phi, tmp, out):
        lap(phi, out=tmp)
        relax(phi, tmp, out=out, domain={I: (1, 31), J: (1, 31)})

    prov = {"Ioff": I, "Joff": J}

    phi_r = gtx.as_field([I, J], data, device=CPU)
    tmp_r = gtx.zeros({I: (1, 31), J: (1, 31)}, device=CPU)
    out_r = gtx.zeros({I: 32, J: 32}, device=CPU)
    smooth(phi_r, tmp_r, out_r, offset_provider=prov)

    # tmp is 30x30 (not mesh-divisible), so it stays unplaced: mixed layouts
    phi_s = shard_field(gtx.as_field([I, J], data, device=CPU), mesh)
    tmp_s = gtx.zeros({I: (1, 31), J: (1, 31)}, device=CPU)
    out_s = shard_field(gtx.zeros({I: 32, J: 32}, device=CPU), mesh)
    smooth(phi_s, tmp_s, out_s, offset_provider=prov)

    np.testing.assert_allclose(asnumpy(out_s), asnumpy(out_r), rtol=1e-12)


def test_sharded_staggered_cgrid(mesh):
    """Staggered premaps (pure domain relabels) with a placed output: the
    C-grid face->center average matches single-device."""
    from gt4py_tpu_torch.next import flip_staggered
    from gt4py_tpu_torch.parallel.next_fields import field_sharding

    IHalf = flip_staggered(I)

    @gtx.field_operator
    def to_centers(u):
        return 0.5 * (u(I + 0.5) + u(I - 0.5))

    rng = np.random.default_rng(17)
    n = 64
    u_np = rng.random(n + 1)

    ref = gtx.zeros({I: (0, n)}, device=CPU)
    to_centers(gtx.as_field([IHalf], u_np, device=CPU), out=ref, offset_provider={})

    out_sharding = field_sharding(mesh, (I,), {I: "x"})
    out_t = torch.zeros(n, dtype=torch.float64)
    out_t.sharding = out_sharding
    out = gtx.Field(gtx.domain({I: (0, n)}), out_t)
    to_centers(gtx.as_field([IHalf], u_np, device=CPU), out=out, offset_provider={})
    np.testing.assert_allclose(asnumpy(out), asnumpy(ref))


def test_sharded_scan_operator(mesh):
    """A K scan over an IJ-placed field: K is whole in every shard, no
    traffic between shards."""
    rng = np.random.default_rng(4)
    data = rng.random((16, 16, 6))
    f = shard_field(gtx.as_field({I: 16, J: 16, K: 6}, data, device=CPU), mesh).ndarray

    @gtx.scan_operator(axis=K, forward=True, init=0.0)
    def kcum(carry: float, x: float) -> float:
        return carry + x

    def step(arr):
        field = gtx.as_field({I: 16, J: 16, K: 6}, arr, device=CPU)
        return kcum(field).ndarray

    res = asnumpy(step(f))
    np.testing.assert_allclose(res, np.cumsum(data, axis=2), rtol=1e-12)


def test_sharded_scan_composition(mesh):
    """Field-operator + scan composition (tridiagonal solve) on placed
    inputs through the embedded path."""
    rng = np.random.default_rng(5)
    shape = (16, 16, 6)
    b = np.full(shape, 4.0)
    a = -np.ones(shape)
    c = -np.ones(shape)
    d = rng.random(shape)

    @gtx.scan_operator(axis=K, forward=True, init=(0.0, 0.0))
    def fwd(carry, a: float, b: float, c: float, d: float):
        cp_prev, dp_prev = carry
        denom = b - a * cp_prev
        return (c / denom, (d - a * dp_prev) / denom)

    @gtx.scan_operator(axis=K, forward=False, init=0.0)
    def bwd(x_kp1, cp: float, dp: float):
        return dp - cp * x_kp1

    def solve(aa, bb, cc, dd):
        fa = gtx.as_field({I: 16, J: 16, K: 6}, aa, device=CPU)
        fb = gtx.as_field({I: 16, J: 16, K: 6}, bb, device=CPU)
        fc = gtx.as_field({I: 16, J: 16, K: 6}, cc, device=CPU)
        fd = gtx.as_field({I: 16, J: 16, K: 6}, dd, device=CPU)
        cp, dp = fwd(fa, fb, fc, fd)
        return bwd(cp, dp).ndarray

    args = [
        shard_field(gtx.as_field({I: 16, J: 16, K: 6}, x, device=CPU), mesh).ndarray
        for x in (a, b, c, d)
    ]
    got = asnumpy(solve(*args))

    from tests import torch_stencil_defs as defs

    expected = defs.validate_tridiagonal_solver(a, b, c, d)
    np.testing.assert_allclose(got, expected, rtol=1e-10)
