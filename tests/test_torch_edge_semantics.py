"""tests/next_tests/test_edge_semantics.py held against gt4py_tpu_torch.

Retargeted copy of the JAX package's test file: package names changed,
the backends ``jax`` -> ``torch``, ``tpu:pallas`` -> ``cuda:hopper`` (on CPU
tensors its kernels' plain version), and every buffer and connectivity
made on the CPU explicitly (``device="cpu"``), since the port's
constructors default to the card. Differences from the reference are
noted where they are.

Edge-case semantics: 2-D staggered combinations, empty/degenerate
domains, dtype edges, scan corner cases, program aliasing patterns
(reference test_execution.py long-tail cases)."""

import numpy as np
import pytest

import gt4py_tpu_torch.next as gtx
from gt4py_tpu_torch.next import Dimension, DimensionKind, FieldOffset, flip_staggered

I = Dimension("I")
J = Dimension("J")
K = Dimension("K", kind=DimensionKind.VERTICAL)
IHalf = flip_staggered(I)
JHalf = flip_staggered(J)
Ioff = FieldOffset("Ioff", source=I, target=(I,))


@pytest.fixture
def rng():
    return np.random.default_rng(21)


# --- 2-D staggered ------------------------------------------------------------


def test_2d_cgrid_divergence(rng):
    """div = du/dx + dv/dy on centers from face-located u (IHalf, J) and
    v (I, JHalf) — the full 2-D C-grid pattern."""

    @gtx.field_operator
    def divergence(u, v):
        dudx = u(I + 0.5) - u(I - 0.5)
        dvdy = v(J + 0.5) - v(J - 0.5)
        return dudx + dvdy

    nu = rng.random((5, 4))  # u over IHalf(0:5), J(0:4)
    nv = rng.random((4, 5))  # v over I(0:4), JHalf(0:5)
    u = gtx.as_field([IHalf, J], nu, device="cpu")
    v = gtx.as_field([I, JHalf], nv, device="cpu")
    out = gtx.zeros({I: 4, J: 4}, device="cpu")
    divergence(u, v, out=out, offset_provider={})
    expected = (nu[1:, :] - nu[:-1, :]) + (nv[:, 1:] - nv[:, :-1])
    np.testing.assert_allclose(out.asnumpy(), expected)


def test_staggered_then_reduction_combination(rng):
    """Staggered premap result feeding arithmetic with a K field."""

    @gtx.field_operator
    def mix(u, w):
        centers = 0.5 * (u(I + 0.5) + u(I - 0.5))
        return centers * w

    nu = rng.random(6)
    nw = rng.random((5, 3))
    u = gtx.as_field([IHalf], nu, device="cpu")
    w = gtx.as_field([I, K], nw, device="cpu")
    out = gtx.zeros({I: 5, K: 3}, device="cpu")
    mix(u, w, out=out, offset_provider={})
    centers = 0.5 * (nu[1:] + nu[:-1])
    np.testing.assert_allclose(out.asnumpy(), centers[:, None] * nw)


# --- degenerate domains -------------------------------------------------------


def test_single_point_domain(rng):
    @gtx.field_operator
    def dbl(a):
        return a * 2.0

    a = gtx.as_field([I], np.array([3.0]), device="cpu")
    out = gtx.zeros({I: 1}, device="cpu")
    dbl(a, out=out)
    np.testing.assert_allclose(out.asnumpy(), [6.0])


def test_shift_consumes_whole_extent(rng):
    """Shifting a 2-point field leaves a 1-point result domain."""

    @gtx.field_operator
    def d(a):
        return a(Ioff[1]) - a

    a = gtx.as_field([I], np.array([1.0, 4.0]), device="cpu")
    out = gtx.zeros({I: 1}, device="cpu")
    d(a, out=out, offset_provider={"Ioff": I})
    np.testing.assert_allclose(out.asnumpy(), [3.0])


# --- dtype edges --------------------------------------------------------------


def test_int_field_operations_stay_int(rng):
    @gtx.field_operator
    def combine(a, b):
        return a * 2 + b

    av = np.arange(5, dtype=np.int32)
    bv = np.ones(5, dtype=np.int32)
    out = gtx.zeros({I: 5}, dtype=np.int32, device="cpu")
    combine(gtx.as_field([I], av, device="cpu"), gtx.as_field([I], bv, device="cpu"), out=out)
    assert out.dtype == np.dtype(np.int32)
    np.testing.assert_array_equal(out.asnumpy(), av * 2 + 1)


def test_bool_field_logic_pipeline(rng):
    @gtx.field_operator
    def flags(a, b):
        return (a > 0.5) & ~(b > 0.5)

    av, bv = rng.random(8), rng.random(8)
    out = gtx.zeros({I: 8}, dtype=bool, device="cpu")
    flags(gtx.as_field([I], av, device="cpu"), gtx.as_field([I], bv, device="cpu"), out=out)
    np.testing.assert_array_equal(out.asnumpy(), (av > 0.5) & ~(bv > 0.5))


# --- scan corners -------------------------------------------------------------


def test_scan_single_level(rng):
    @gtx.scan_operator(axis=K, forward=True, init=10.0)
    def acc(c, x):
        return c + x

    out = gtx.zeros({K: 1}, device="cpu")
    acc(gtx.as_field([K], np.array([5.0]), device="cpu"), out=out)
    np.testing.assert_allclose(out.asnumpy(), [15.0])


def test_scan_with_scalar_kwarg(rng):
    @gtx.scan_operator(axis=K, forward=True, init=0.0)
    def damped(c, x, alpha: float):
        return alpha * c + x

    xv = rng.random(6)
    out = gtx.zeros({K: 6}, device="cpu")
    damped(gtx.as_field([K], xv, device="cpu"), alpha=0.5, out=out)
    expect = np.zeros(6)
    c = 0.0
    for k in range(6):
        c = 0.5 * c + xv[k]
        expect[k] = c
    np.testing.assert_allclose(out.asnumpy(), expect)
    # new alpha value reuses the pooled executable with a fresh trace-arg
    damped(gtx.as_field([K], xv, device="cpu"), alpha=0.0, out=out)
    np.testing.assert_allclose(out.asnumpy(), xv)


def test_scan_mixed_field_and_2d(rng):
    """Scan consuming one K-only and one (I, K) argument broadcasts the
    K-only stream across I."""

    @gtx.scan_operator(axis=K, forward=True, init=0.0)
    def acc(c, column, plane):
        return c + column * plane

    col = rng.random(4)
    pl = rng.random((3, 4))
    out = gtx.zeros({I: 3, K: 4}, device="cpu")
    acc(gtx.as_field([K], col, device="cpu"), gtx.as_field([I, K], pl, device="cpu"), out=out)
    np.testing.assert_allclose(out.asnumpy(), np.cumsum(col[None, :] * pl, axis=1))


# --- program aliasing ---------------------------------------------------------


def test_program_ping_pong_buffers(rng):
    """Alternating in/out buffers across calls (time-stepping pattern)."""

    @gtx.field_operator
    def smooth(a):
        return 0.5 * a

    @gtx.program
    def prog(src, dst):
        smooth(src, out=dst)

    a = gtx.as_field([I], np.ones(4) * 8.0, device="cpu")
    b = gtx.zeros({I: 4}, device="cpu")
    prog(a, b)
    prog(b, a)
    prog(a, b)
    np.testing.assert_allclose(b.asnumpy(), np.ones(4))


def test_program_repeated_operator_different_outs(rng):
    @gtx.field_operator
    def inc(a):
        return a + 1.0

    @gtx.program
    def prog(a, o1, o2):
        inc(a, out=o1)
        inc(o1, out=o2)
        inc(o2, out=o1)

    a = gtx.as_field([I], np.zeros(4), device="cpu")
    o1 = gtx.zeros({I: 4}, device="cpu")
    o2 = gtx.zeros({I: 4}, device="cpu")
    prog(a, o1, o2)
    np.testing.assert_allclose(o1.asnumpy(), 3.0 * np.ones(4))
    np.testing.assert_allclose(o2.asnumpy(), 2.0 * np.ones(4))


def test_out_exceeding_result_domain_errors_clearly(rng):
    Ioff2 = FieldOffset("Ioff2", source=I, target=(I,))

    @gtx.field_operator
    def shifted(a):
        return a(Ioff2[1]) + a(Ioff2[-1])

    a = gtx.as_field([I], rng.random(8), device="cpu")
    out = gtx.zeros({I: 8}, device="cpu")  # result only covers I=(1:7)
    with pytest.raises(ValueError, match="exceeds the operator result domain"):
        shifted(a, out=out, offset_provider={"Ioff2": I})


def test_in_place_out_aliasing(rng):
    """op(f, out=f) — the same field as input and output (time-stepping
    shorthand); the fused write-back must read before writing."""

    @gtx.field_operator
    def bump(x):
        return x + 1.0

    f = gtx.as_field([I], np.arange(4.0), device="cpu")
    bump(f, out=f)
    bump(f, out=f)
    np.testing.assert_allclose(f.asnumpy(), np.arange(4.0) + 2.0)


def test_in_place_with_shift_aliasing(rng):
    """In-place with a shifted read: every point must see the OLD values
    (no sequential in-place update effects)."""
    Ioff3 = FieldOffset("Ioff3", source=I, target=(I,))

    @gtx.field_operator
    def avg(x):
        return 0.5 * (x(Ioff3[1]) + x(Ioff3[-1]))

    data = rng.random(8)
    f = gtx.as_field([I], data.copy(), device="cpu")
    out = gtx.zeros({I: (1, 7)}, device="cpu")
    avg(f, out=out, offset_provider={"Ioff3": I})
    expected = 0.5 * (data[2:] + data[:-2])
    np.testing.assert_allclose(out.asnumpy(), expected)


def test_staggered_vertical_integral(rng):
    """Hydrostatic-style column integral: layer thickness from staggered
    half-level heights, then a downward pressure accumulation — staggered
    premap + scan interplay."""
    KHalf = flip_staggered(K)

    @gtx.field_operator
    def thickness(zh):
        return zh(K - 0.5) - zh(K + 0.5)  # z(k-½) - z(k+½)

    @gtx.scan_operator(axis=K, forward=True, init=0.0)
    def integrate(c, dz):
        return c + dz

    nk = 6
    z_half = np.sort(rng.random(nk + 1))[::-1].copy()  # decreasing heights
    zh = gtx.as_field([KHalf], z_half, device="cpu")
    dz = gtx.zeros({K: (0, nk)}, device="cpu")
    thickness(zh, out=dz, offset_provider={})
    expected_dz = z_half[:-1] - z_half[1:]
    np.testing.assert_allclose(dz.asnumpy(), expected_dz)

    p = gtx.zeros({K: (0, nk)}, device="cpu")
    integrate(dz, out=p)
    np.testing.assert_allclose(p.asnumpy(), np.cumsum(expected_dz))
