"""tests/next_tests/test_field_ops.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

Field-view DSL tests: cartesian operators, scans, unstructured
neighbor reductions (mirrors reference next_tests workloads: laplacian,
column scans, FVM nabla with a toy connectivity —
upstream gt4py tests/next_tests/integration_tests/...)."""

import numpy as np
import pytest

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.next import (
    Dimension,
    DimensionKind,
    FieldOffset,
    neighbor_sum,
    where,
)

IDim = Dimension("IDim")
JDim = Dimension("JDim")
KDim = Dimension("KDim", kind=DimensionKind.VERTICAL)

Ioff = FieldOffset("Ioff", source=IDim, target=(IDim,))
Joff = FieldOffset("Joff", source=JDim, target=(JDim,))

CART_PROVIDER = {"Ioff": IDim, "Joff": JDim}


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# --- cartesian field operators ----------------------------------------------


@gtx.field_operator
def lap(phi):
    return (
        -4.0 * phi
        + phi(Ioff[1])
        + phi(Ioff[-1])
        + phi(Joff[1])
        + phi(Joff[-1])
    )


@pytest.mark.parametrize("backend", [None, "torch"])
def test_laplacian(backend, rng):
    n = 10
    data = rng.random((n, n))
    phi = gtx.as_field([IDim, JDim], data, device="cpu")
    out = gtx.zeros({IDim: (1, n - 1), JDim: (1, n - 1)}, device="cpu")
    lap.with_backend(backend)(phi, out=out, offset_provider=CART_PROVIDER)
    expected = (
        -4 * data[1:-1, 1:-1]
        + data[2:, 1:-1]
        + data[:-2, 1:-1]
        + data[1:-1, 2:]
        + data[1:-1, :-2]
    )
    np.testing.assert_allclose(out.asnumpy(), expected)


@gtx.field_operator
def laplap(phi):
    return lap(lap(phi))


def test_nested_operator_call(rng):
    n = 12
    data = rng.random((n, n))
    phi = gtx.as_field([IDim, JDim], data, device="cpu")
    out = gtx.zeros({IDim: (2, n - 2), JDim: (2, n - 2)}, device="cpu")
    laplap(phi, out=out, offset_provider=CART_PROVIDER)

    def np_lap(a):
        return -4 * a[1:-1, 1:-1] + a[2:, 1:-1] + a[:-2, 1:-1] + a[1:-1, 2:] + a[1:-1, :-2]

    np.testing.assert_allclose(out.asnumpy(), np_lap(np_lap(data)))


@gtx.field_operator
def conditional_flux(a, b):
    diff = a(Ioff[1]) - a
    return where(diff * b > 0.0, 0.0, diff)


def test_where_builtin(rng):
    n = 8
    a = rng.random(n)
    b = rng.random(n) - 0.5
    fa = gtx.as_field([IDim], a, device="cpu")
    fb = gtx.as_field([IDim], b, device="cpu")
    out = gtx.zeros({IDim: n - 1}, device="cpu")
    conditional_flux(fa, fb, out=out, offset_provider=CART_PROVIDER)
    diff = a[1:] - a[:-1]
    np.testing.assert_allclose(out.asnumpy(), np.where(diff * b[:-1] > 0, 0.0, diff))


def test_broadcast_and_astype(rng):
    data = rng.random(5)
    f = gtx.as_field([IDim], data, device="cpu")
    g = gtx.broadcast(f, (IDim, KDim))
    h = g + gtx.zeros({IDim: 5, KDim: 3}, device="cpu")
    assert h.domain.shape == (5, 3)
    np.testing.assert_allclose(h.asnumpy(), np.broadcast_to(data[:, None], (5, 3)))
    i = gtx.astype(f, np.float32)
    assert i.dtype == np.float32


# --- scan operators ----------------------------------------------------------


@gtx.scan_operator(axis=KDim, forward=True, init=0.0)
def cumsum_k(carry, x):
    return carry + x


def test_scan_cumsum(rng):
    data = rng.random((4, 6))
    f = gtx.as_field([IDim, KDim], data, device="cpu")
    out = gtx.zeros({IDim: 4, KDim: 6}, device="cpu")
    cumsum_k(f, out=out, offset_provider={})
    np.testing.assert_allclose(out.asnumpy(), np.cumsum(data, axis=1))


@gtx.scan_operator(axis=KDim, forward=False, init=0.0)
def cumsum_down(carry, x):
    return carry + x


def test_scan_backward(rng):
    data = rng.random((3, 5))
    f = gtx.as_field([IDim, KDim], data, device="cpu")
    out = gtx.zeros({IDim: 3, KDim: 5}, device="cpu")
    cumsum_down(f, out=out, offset_provider={})
    np.testing.assert_allclose(out.asnumpy(), np.cumsum(data[:, ::-1], axis=1)[:, ::-1])


@gtx.scan_operator(axis=KDim, forward=True, init=(0.0, 0.0))
def tuple_scan(carry, x):
    s, prod_sum = carry
    return (s + x, prod_sum + s * x)


def test_tuple_carry_scan(rng):
    data = rng.random((2, 4))
    f = gtx.as_field([IDim, KDim], data, device="cpu")
    s, ps = tuple_scan(f, offset_provider={})
    np.testing.assert_allclose(s.asnumpy(), np.cumsum(data, axis=1))


# --- program -----------------------------------------------------------------


@gtx.program
def lap_program(phi, out):
    lap(phi, out=out)


def test_program(rng):
    n = 6
    data = rng.random((n, n))
    phi = gtx.as_field([IDim, JDim], data, device="cpu")
    out = gtx.zeros({IDim: (1, n - 1), JDim: (1, n - 1)}, device="cpu")
    lap_program(phi, out, offset_provider=CART_PROVIDER)
    expected = (
        -4 * data[1:-1, 1:-1] + data[2:, 1:-1] + data[:-2, 1:-1] + data[1:-1, 2:] + data[1:-1, :-2]
    )
    np.testing.assert_allclose(out.asnumpy(), expected)


# --- unstructured: FVM nabla (BASELINE config) -------------------------------

Vertex = Dimension("Vertex")
Edge = Dimension("Edge")
V2EDim = Dimension("V2E", kind=DimensionKind.LOCAL)
E2VDim = Dimension("E2V", kind=DimensionKind.LOCAL)

E2V = FieldOffset("E2V", source=Vertex, target=(Edge, E2VDim))
V2E = FieldOffset("V2E", source=Edge, target=(Vertex, V2EDim))


def make_periodic_mesh(n):
    """Periodic n x n quad mesh: n^2 vertices, 2 n^2 edges (horizontal then
    vertical). Returns (e2v, v2e, signs)."""
    nv = n * n

    def vid(i, j):
        return (i % n) * n + (j % n)

    e2v = []
    for i in range(n):
        for j in range(n):
            e2v.append([vid(i, j), vid(i + 1, j)])  # horizontal edge
    for i in range(n):
        for j in range(n):
            e2v.append([vid(i, j), vid(i, j + 1)])  # vertical edge
    e2v = np.asarray(e2v)

    v2e = np.zeros((nv, 4), dtype=np.int64)
    signs = np.zeros((nv, 4))
    for i in range(n):
        for j in range(n):
            v = vid(i, j)
            h = lambda a, b: (a % n) * n + (b % n)  # noqa: E731
            v2e[v] = [
                h(i, j),            # outgoing horizontal
                h(i - 1, j),        # incoming horizontal
                n * n + h(i, j),    # outgoing vertical
                n * n + h(i, j - 1),  # incoming vertical
            ]
            signs[v] = [1.0, -1.0, 1.0, -1.0]
    return e2v, v2e, signs


@gtx.field_operator
def nabla_x(pp, s_x, sign, vol):
    zavg = 0.5 * (pp(E2V[0]) + pp(E2V[1])) * s_x
    return neighbor_sum(zavg(V2E) * sign, axis=V2EDim) / vol


@pytest.mark.parametrize("backend", [None, "torch"])
def test_fvm_nabla(backend, rng):
    n = 6
    e2v_np, v2e_np, signs_np = make_periodic_mesh(n)
    nv, ne = n * n, 2 * n * n

    pp_np = rng.random(nv)
    sx_np = rng.random(ne)
    vol_np = rng.random(nv) + 0.5

    pp = gtx.as_field([Vertex], pp_np, device="cpu")
    s_x = gtx.as_field([Edge], sx_np, device="cpu")
    sign = gtx.as_field([Vertex, V2EDim], signs_np, device="cpu")
    vol = gtx.as_field([Vertex], vol_np, device="cpu")
    e2v = gtx.as_connectivity([Edge, E2VDim], Vertex, e2v_np, device="cpu")
    v2e = gtx.as_connectivity([Vertex, V2EDim], Edge, v2e_np, device="cpu")

    out = gtx.zeros({Vertex: nv}, device="cpu")
    nabla_x.with_backend(backend)(
        pp, s_x, sign, vol, out=out, offset_provider={"E2V": e2v, "V2E": v2e}
    )

    # NumPy oracle straight from the tables.
    zavg = 0.5 * (pp_np[e2v_np[:, 0]] + pp_np[e2v_np[:, 1]]) * sx_np
    expected = (zavg[v2e_np] * signs_np).sum(axis=1) / vol_np
    np.testing.assert_allclose(out.asnumpy(), expected, rtol=1e-12)


def test_skip_value_masking(rng):
    """Neighbor sums ignore skip_value entries."""
    V = Dimension("V")
    E = Dimension("E")
    VN = Dimension("VN", kind=DimensionKind.LOCAL)
    table = np.array([[0, 1, -1], [1, -1, -1]])
    conn = gtx.as_connectivity([V, VN], E, table, skip_value=-1, device="cpu")
    edge_vals = gtx.as_field([E], np.array([10.0, 20.0]), device="cpu")
    gathered = edge_vals(conn)
    s = neighbor_sum(gathered, axis=VN)
    np.testing.assert_allclose(s.asnumpy(), [30.0, 20.0])


def test_concat_where(rng):
    from gt4py_tpu_torch.next.fbuiltins import concat_where

    surface = gtx.as_field([IDim], rng.random(4), device="cpu")
    interior = gtx.as_field([IDim, KDim], rng.random((4, 6)), device="cpu")
    out = concat_where(KDim == 0, gtx.broadcast(surface, (IDim, KDim)), interior)
    expected = interior.asnumpy().copy()
    expected[:, 0] = surface.asnumpy()
    np.testing.assert_allclose(out.asnumpy(), expected)

    out2 = concat_where(KDim < 2, 0.0, interior)
    expected2 = interior.asnumpy().copy()
    expected2[:, :2] = 0.0
    np.testing.assert_allclose(out2.asnumpy(), expected2)
